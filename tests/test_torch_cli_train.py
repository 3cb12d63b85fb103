"""The CLI's trainer jobs on the port, ``--device=cpu``, against the
cases of ``tests/test_cli.py``: train then infer from the saved
parameters, ``time`` and ``measure_time``, infer from a merged artifact,
and ``checkgrad`` (fp32 compute, as ``tests/conftest.py`` sets it). The
config builds its layers with ``paddle_tpu_torch``; the JAX CLI runs the
same config written for ``paddle_tpu``, and the parameters each saves
load into the other package.
"""

import os
import pickle

import numpy as np
import pytest

from paddle_tpu import cli as jcli
from paddle_tpu_torch import cli
from tests.torch_layers_util import keep_global_seed  # noqa: F401

pytestmark = pytest.mark.usefixtures("keep_global_seed")

CONFIG = """
import numpy as np
import {pkg} as paddle
from {pkg} import layer

img = layer.data("image", paddle.data_type.dense_vector(16))
lbl = layer.data("label", paddle.data_type.integer_value(4))
h = layer.fc(img, 8, act=paddle.activation.Relu(), name="cli_h")
out = layer.fc(h, 4, act=paddle.activation.Softmax(), name="cli_out")
cost = layer.classification_cost(out, lbl, name="cost")
outputs = [out]
batch_size = 8

_rng = np.random.RandomState(0)
_data = [( _rng.rand(16).astype("float32"), int(_rng.randint(4)) )
         for _ in range(32)]

def reader():
    return iter(_data)

def infer_reader():
    return iter([(x,) for x, _ in _data])
"""


def _write_config(tmp_path, pkg="paddle_tpu_torch"):
    p = tmp_path / f"conf_{pkg}.py"
    p.write_text(CONFIG.format(pkg=pkg))
    return str(p)


class TestCliJobs:
    def test_train_then_infer_from_saved(self, tmp_path):
        conf = _write_config(tmp_path)
        save_dir = str(tmp_path / "out")
        rc = cli.main(["train", f"--config={conf}", "--num_passes=1",
                       f"--save_dir={save_dir}", "--device=cpu"])
        assert rc == 0
        tar = os.path.join(save_dir, "pass-00000", "params.tar")
        assert os.path.exists(tar)
        out_npz = str(tmp_path / "preds.npz")
        rc = cli.main(["infer", f"--config={conf}",
                       f"--init_model_path={tar}",
                       f"--output_path={out_npz}", "--infer_limit=8",
                       "--device=cpu"])
        assert rc == 0
        preds = np.load(out_npz)["cli_out"]
        assert preds.shape == (8, 4)
        np.testing.assert_allclose(preds.sum(-1), 1.0, rtol=1e-4)

    def test_saved_parameters_load_in_the_jax_cli(self, tmp_path):
        """The port's saved tar infers through the JAX CLI to the port's
        predictions (within 1e-5)."""
        conf = _write_config(tmp_path)
        save_dir = str(tmp_path / "out")
        assert cli.main(["train", f"--config={conf}", "--num_passes=2",
                         f"--save_dir={save_dir}", "--device=cpu"]) == 0
        tar = os.path.join(save_dir, "pass-00001", "params.tar")
        with open(tar, "rb") as f:
            assert set(pickle.load(f)["values"]) == {
                "cli_h.w", "cli_h.b", "cli_out.w", "cli_out.b"}
        outs = []
        for main, c in ((cli.main, conf),
                        (jcli.main, _write_config(tmp_path, "paddle_tpu"))):
            npz = str(tmp_path / f"p{len(outs)}.npz")
            argv = ["infer", f"--config={c}", f"--init_model_path={tar}",
                    f"--output_path={npz}"]
            assert main(argv + (["--device=cpu"] if main is cli.main
                                else [])) == 0
            outs.append(np.load(npz)["cli_out"])
        np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5)

    def test_job_time_measures(self, tmp_path, capsys):
        conf = _write_config(tmp_path)
        rc = cli.main(["time", f"--config={conf}", "--time_batches=2",
                       "--warmup_batches=1", "--device=cpu"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "ms/batch" in out and "examples/sec" in out

    def test_measure_time_returns_metrics(self, tmp_path):
        cfg = cli._load_config(_write_config(tmp_path))
        r = cli.measure_time(cfg, time_batches=2, warmup_batches=1,
                             device="cpu")
        assert r["ms_per_batch"] > 0
        assert r["timed_batches"] == 2
        assert r["flops_per_batch"] == 2 * 8 * (16 * 8 + 8 * 4) \
            + 2 * 8 * 8 * 4 * 2 + 2 * 8 * 16 * 8
        assert r["mfu"] is None and r["peak_memory_bytes"] is None

    def test_test_job(self, tmp_path, capsys):
        conf = _write_config(tmp_path)
        assert cli.main(["test", f"--config={conf}", "--device=cpu"]) == 0
        assert "test: cost" in capsys.readouterr().out

    def test_infer_from_merged_model(self, tmp_path):
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch import layer
        from paddle_tpu_torch.io import merged
        img = layer.data("image", paddle.data_type.dense_vector(16))
        h = layer.fc(img, 8, act=paddle.activation.Relu(), name="cm_h")
        out = layer.fc(h, 4, act=paddle.activation.Softmax(), name="cm_out")
        params = paddle.parameters.create(out, device="cpu")
        model = str(tmp_path / "m.tar")
        merged.save_inference_model(model, out, params)

        conf = _write_config(tmp_path)
        out_npz = str(tmp_path / "preds.npz")
        rc = cli.main(["infer", f"--config={conf}", f"--model={model}",
                       f"--output_path={out_npz}", "--infer_limit=8",
                       "--device=cpu"])
        assert rc == 0
        preds = np.load(out_npz)["cm_out"]
        assert preds.shape == (8, 4)

    def test_checkgrad_passes(self, tmp_path, capsys):
        """Central differences of the fp32 cost against autograd on a
        smooth (tanh) net from a fixed seed; eps 1e-2 keeps the
        differences' rounding below the 2e-2 bar."""
        import paddle_tpu_torch as T
        conf = tmp_path / "tanh.py"
        conf.write_text(CONFIG.format(pkg="paddle_tpu_torch").replace(
            "paddle.activation.Relu()", "paddle.activation.Tanh()"))
        T.init(seed=1)
        assert cli.main(["checkgrad", f"--config={conf}", "--device=cpu",
                         "--checkgrad_eps=1e-2"]) == 0
        out = capsys.readouterr().out
        assert "checkgrad worst rel err" in out and "FAIL" not in out

    def test_metrics_out_and_trace(self, tmp_path):
        from paddle_tpu_torch import observe
        conf = _write_config(tmp_path)
        m, tr = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
        try:
            assert cli.main(["train", f"--config={conf}", "--device=cpu",
                             f"--metrics_out={m}", f"--trace={tr}"]) == 0
        finally:
            observe.configure(None)
        kinds = [r["kind"] for r in observe.read_jsonl(m)]
        assert kinds.count("step") == 4 and kinds[-1] == "pass"
        assert os.path.exists(tr)

    def test_trainer_job_needs_a_config(self, capsys):
        import pytest
        with pytest.raises(SystemExit):
            cli.main(["train", "--device=cpu"])
