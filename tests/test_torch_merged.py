"""The port's merged-model artifact against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_merged_model.py``: the topology's dict round
trip, an unrecordable graph refused, the same-process round trip,
``aot_compile`` (a ``StepProgram`` of the replayed forward), the fixed
batch-size path (``call_exported``; the port stamps the sizes and
compiles nothing at save, so there is no cost analysis), a fresh process
that imports no model-building code, and the ``weights_int8`` artifact.
Plus the two packages reading each other's files: a JAX-written artifact
(its StableHLO ``exported_bs*.bin`` skipped) replayed by the port, a
port-written one replayed by the JAX package, the recorded API paths
both packages write, the int8 codes and scales byte for byte, and the
attention seq2seq generator, whose recorded step sub-graph only the port
can replay.

Tolerances: fp32 outputs 1e-5 (1e-6 within one package); ids, int8 codes
and scales exact.
"""

import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.io import merged as jmerged
from paddle_tpu.utils.rng import KeySource as JKS
from paddle_tpu_torch.io import merged as tmerged
from paddle_tpu_torch.utils.rng import KeySource as TKS
from tests.torch_layers_util import Net, carry
from tests.test_torch_networks import seq2seq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(P, w=32):
    img = P.layer.data("image", P.data_type.dense_vector(64))
    h = P.layer.fc(img, w, act=P.activation.Relu(), name="mm_h")
    return P.layer.fc(h, 10, act=P.activation.Softmax(), name="mm_out")


def _port_params(out, seed=5):
    return T.parameters.create(out, TKS(seed), device="cpu")


class TestTopologyRoundTrip:
    def test_from_dict_same_forward(self, rng):
        out = _model(T)
        topo = T.topology.Topology(out)
        params = _port_params(out, 3)
        x = rng.randn(4, 64).astype(np.float32)
        want, _ = topo.compile()(params.values, params.state, {"image": x})
        d = json.loads(json.dumps(topo.to_dict()))
        assert {l["config"]["api"] for l in d["layers"]} == {
            "paddle_tpu.layer.data", "paddle_tpu.layer.fc"}
        topo2 = T.topology.Topology.from_dict(d)
        got, _ = topo2.compile()(params.values, params.state, {"image": x})
        np.testing.assert_array_equal(got["mm_out"].array.numpy(),
                                      want["mm_out"].array.numpy())

    def test_unrecordable_graph_raises(self, tmp_path):
        from paddle_tpu_torch.topology import LayerOutput, Value
        raw = LayerOutput("raw", "custom", [], lambda p, vals, ctx: Value(None))
        topo = T.topology.Topology(raw)
        assert not topo.is_rebuildable()
        with pytest.raises(ValueError, match="creation record"):
            T.topology.Topology.from_dict(topo.to_dict())
        with pytest.raises(ValueError, match="unrecordable"):
            tmerged.save_inference_model(str(tmp_path / "x.tar"), raw,
                                         _port_params(raw),
                                         export_batch_sizes=(4,))


class TestMergedArtifact:
    def _save(self, tmp_path, export=(), **kw):
        out = _model(T)
        params = _port_params(out)
        path = str(tmp_path / "model.tar")
        tmerged.save_inference_model(path, out, params,
                                     export_batch_sizes=export, **kw)
        return path, out, params

    def test_same_process_roundtrip(self, tmp_path, rng):
        path, out, params = self._save(tmp_path)
        x = rng.randn(6, 64).astype(np.float32)
        want = T.infer(output_layer=out, parameters=params,
                       input=[(r,) for r in x])
        m = tmerged.load_inference_model(path, device="cpu")
        np.testing.assert_allclose(m.infer({"image": x})["mm_out"], want,
                                   rtol=1e-6, atol=1e-7)
        with tarfile.open(path) as tar:
            assert sorted(tar.getnames()) == ["meta.json", "params.npz",
                                              "state.npz", "topology.json"]

    def test_aot_compile(self, tmp_path, rng):
        path, _, _ = self._save(tmp_path)
        m = tmerged.load_inference_model(path, device="cpu")
        compiled = m.aot_compile(batch_size=4)
        x = rng.randn(4, 64).astype(np.float32)
        outs = compiled(m.params, m.state, {"image": x})
        np.testing.assert_array_equal(outs["mm_out"].numpy(),
                                      m.infer({"image": x})["mm_out"])

    def test_exported_batch_sizes(self, tmp_path, rng):
        path, _, _ = self._save(tmp_path, export=(4,))
        m = tmerged.load_inference_model(path, device="cpu")
        assert m.meta["export_batch_sizes"] == [4]
        x = rng.randn(4, 64).astype(np.float32)
        np.testing.assert_array_equal(m.call_exported({"image": x})["mm_out"],
                                      m.infer({"image": x})["mm_out"])
        with pytest.raises(KeyError):
            m.call_exported({"image": rng.randn(3, 64).astype(np.float32)})
        assert m.cost_analysis == {}

    def test_fresh_process_no_model_code(self, tmp_path, rng):
        """A separate process loads the tar and infers, importing only
        ``paddle_tpu_torch`` (never JAX, never this module)."""
        path, out, params = self._save(tmp_path, export=(4,))
        x = rng.randn(4, 64).astype(np.float32)
        np.save(tmp_path / "x.npy", x)
        want = T.infer(output_layer=out, parameters=params,
                       input=[(r,) for r in x])
        script = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from paddle_tpu_torch.io import merged
m = merged.load_inference_model({path!r}, device="cpu")
x = np.load({str(tmp_path / 'x.npy')!r})
np.save({str(tmp_path / 'got.npy')!r}, m.infer({{"image": x}})["mm_out"])
np.save({str(tmp_path / 'exp.npy')!r}, m.call_exported({{"image": x}})["mm_out"])
assert not any(k == "jax" or k.startswith("paddle_tpu.") for k in sys.modules)
"""
        env = dict(os.environ, PADDLE_TPU_COMPUTE_DTYPE="float32")
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        np.testing.assert_allclose(np.load(tmp_path / "got.npy"), want,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.load(tmp_path / "exp.npy"), want,
                                   rtol=1e-6, atol=1e-7)


def test_weights_int8_artifact(tmp_path):
    def b(P):
        img = P.layer.data("px", P.data_type.dense_vector(64))
        h = P.layer.fc(img, 128, act=P.activation.Relu(), name="w8_h")
        return P.layer.fc(h, 10, act=P.activation.Softmax(), name="w8_o")
    out = b(T)
    params = _port_params(out)
    x = np.random.RandomState(0).rand(4, 64).astype(np.float32)
    p_f, p_q = str(tmp_path / "m_f.tar"), str(tmp_path / "m_q.tar")
    tmerged.save_inference_model(p_f, out, params, export_batch_sizes=(4,))
    tmerged.save_inference_model(p_q, out, params, export_batch_sizes=(4,),
                                 weights_int8=True)

    def payload(p):
        with tarfile.open(p) as t:
            return len(t.extractfile("params.npz").read())

    assert payload(p_q) < 0.5 * payload(p_f)
    mf = tmerged.load_inference_model(p_f, device="cpu")
    mq = tmerged.load_inference_model(p_q, device="cpu")
    assert mq.meta["weights_int8"] is True and mq.meta["format_version"] == 2
    rf, rq = mf.infer({"px": x})["w8_o"], mq.infer({"px": x})["w8_o"]
    assert np.abs(rf - rq).max() < 0.02
    ef = mf.call_exported({"px": x})["w8_o"]
    eq = mq.call_exported({"px": x})["w8_o"]
    assert np.abs(ef - eq).max() < 0.02
    np.testing.assert_array_equal(eq, rq)


class TestAcrossPackages:
    @pytest.fixture(scope="class")
    def jax_model(self, tmp_path_factory):
        """A JAX-written artifact with a compiled module (batch 4), plain
        and int8."""
        d = tmp_path_factory.mktemp("jaxmm")
        out = _model(J, w=160)
        params = J.parameters.create(out, JKS(9))
        paths = {}
        for q in (False, True):
            paths[q] = str(d / f"m{int(q)}.tar")
            jmerged.save_inference_model(paths[q], out, params,
                                         export_batch_sizes=(4,),
                                         weights_int8=q)
        return out, params, paths

    def test_jax_artifact_replays_in_the_port(self, jax_model, rng):
        out, params, paths = jax_model
        x = rng.randn(4, 64).astype(np.float32)
        for q, path in paths.items():
            with tarfile.open(path) as tar:
                assert "exported_bs4.bin" in tar.getnames()
            jm = jmerged.load_inference_model(path)
            tm = tmerged.load_inference_model(path, device="cpu")
            want = jm.infer({"image": x})["mm_out"]
            np.testing.assert_allclose(tm.infer({"image": x})["mm_out"],
                                       want, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(
                tm.call_exported({"image": x})["mm_out"],
                tm.infer({"image": x})["mm_out"])

    def test_port_artifact_replays_in_jax(self, tmp_path, rng):
        out = _model(T)
        params = _port_params(out, 4)
        x = rng.randn(5, 64).astype(np.float32)
        for q in (False, True):
            path = str(tmp_path / f"p{int(q)}.tar")
            tmerged.save_inference_model(path, out, params, weights_int8=q)
            tm = tmerged.load_inference_model(path, device="cpu")
            jm = jmerged.load_inference_model(path)
            np.testing.assert_allclose(tm.infer({"image": x})["mm_out"],
                                       jm.infer({"image": x})["mm_out"],
                                       rtol=1e-5, atol=1e-6)

    def test_int8_codes_byte_for_byte(self, jax_model, tmp_path):
        """The port's quantize_v2_params over the same fp32 weights gives
        the JAX package's codes and scales, and the same npz keys."""
        out, jparams, paths = jax_model
        tout = _model(T, w=160)
        tparams = carry(jparams, T.topology.Topology(tout))
        tpath = str(tmp_path / "q.tar")
        tmerged.save_inference_model(tpath, tout, tparams, weights_int8=True)

        def npz(path):
            with tarfile.open(path) as tar:
                raw = tar.extractfile("params.npz").read()
            with np.load(io.BytesIO(raw)) as z:
                return {k: z[k] for k in z.files}
        jz, tz = npz(paths[True]), npz(tpath)
        assert sorted(jz) == sorted(tz)
        assert any(k.endswith("@q8") for k in tz)
        for k in jz:
            assert jz[k].dtype == tz[k].dtype, k
            assert jz[k].tobytes() == tz[k].tobytes(), k


def test_seq2seq_generator_artifact(tmp_path, rng):
    """The generator's ``beam_search`` step sub-graph is recorded by the
    port (the JAX package serves it only as a compiled module): saved,
    reloaded and replayed, its ids equal the in-process ones, which equal
    the JAX generator's on the same weights."""
    gen = Net(lambda P: seq2seq(P, generate=True), init="numpy")
    rows = [(list(rng.randint(2, 30, n)),) for n in (5, 8, 3)]
    j, t = gen.check_rows(rows)
    tparams = gen.tparams
    for q in (False, True):
        path = str(tmp_path / f"gen{int(q)}.tar")
        tmerged.save_inference_model(path, gen.tout, tparams, weights_int8=q)
        m = tmerged.load_inference_model(path, device="cpu")
        with pytest.raises(ValueError, match="cannot decode"):
            jmerged.load_inference_model(path)
        feeds = T.data_feeder.DataFeeder(
            {"source_language_word": T.data_type.integer_value_sequence(30)},
            device="cpu").feed(rows)["source_language_word"]
        got = m.infer({"source_language_word": feeds.array.numpy(),
                       "source_language_word.lengths":
                           feeds.lengths.numpy()})["generated_word"]
        if not q:
            np.testing.assert_array_equal(
                got, t[0]["generated_word"].array.numpy())
        assert got.shape == (3, 3, 6)
