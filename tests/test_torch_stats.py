"""The port CLI's ``stats`` job against ``paddle_tpu``'s on the CPU.

The ``stats`` cases of ``tests/test_observe.py``,
``tests/test_profiling.py`` and ``tests/test_request_observability.py``
run against the port's CLI over the port's trainer and observability
state. Over one JSONL step log (the port trainer's, and a hand-written one
with pass and other records), ``stats --metrics_file`` (with and without
``--last``) prints the JAX CLI's lines; ``--merge`` of two per-rank trace
exports prints the same line and writes the same merged timeline; the
error paths return 1 as the reference's do; and ``python -m
paddle_tpu_torch stats`` runs as a process.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu import cli as jcli
from paddle_tpu import observe as jobserve
from paddle_tpu_torch import cli, layer, observe

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolate_observe():
    observe.reset()
    jobserve.reset()
    yield
    observe.reset()
    jobserve.reset()


def _smallnet():
    img = layer.data("x", paddle.data_type.dense_vector(8))
    lbl = layer.data("y", paddle.data_type.integer_value(3))
    # named: an auto-named layer would advance the port's name counter
    # alone, which other files' tests hold apart from the JAX package's
    out = layer.fc(img, 3, act=paddle.activation.Softmax(), name="st_out")
    cost = layer.classification_cost(out, lbl, name="cost")
    params = paddle.parameters.create(cost, device="cpu")
    return paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(learning_rate=0.1))


def _data(n=40):
    r = np.random.RandomState(0)
    return [(r.rand(8).astype("float32"), int(r.randint(3)))
            for _ in range(n)]


def _train_log(path, n=40):
    observe.configure(str(path))
    tr = _smallnet()
    tr.train(paddle.batch(lambda: iter(_data(n)), 8), num_passes=1)
    observe.configure(None)
    return path


def _both(argv, capsys):
    """(rc, stdout) of the port's CLI, then of the JAX CLI."""
    out = []
    for main in (cli.main, jcli.main):
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_stats_cli_renders_jsonl(tmp_path, capsys):
    path = _train_log(tmp_path / "train.jsonl")
    assert cli.main(["stats", f"--metrics_file={path}"]) == 0
    out = capsys.readouterr().out
    assert "steps" in out and "examples/sec" in out and "loss" in out
    assert "(5 steps, 1 passes)" in out


@pytest.mark.parametrize("last", [0, 3])
def test_stats_metrics_file_prints_the_jax_cli_lines(tmp_path, capsys,
                                                      last):
    path = _train_log(tmp_path / "train.jsonl")
    argv = ["stats", f"--metrics_file={path}", f"--last={last}"]
    (trc, tout), (jrc, jout) = _both(argv, capsys)
    assert trc == jrc == 0
    assert tout == jout
    assert ("--- last 3 records ---" in tout) == bool(last)


def test_stats_hand_written_log_prints_the_jax_cli_lines(tmp_path, capsys):
    recs = [{"kind": "step", "wall_time_s": w, "examples_per_sec": e,
             "loss": l, "recompile": i == 0}
            for i, (w, e, l) in enumerate([(0.5, 16.0, 2.5), (0.1, 80.0,
                                                              2.25),
                                           (0.2, 40.0, 2.0)])]
    recs += [{"kind": "step", "wall_time_s": "n/a"},
             {"kind": "pass", "pass_id": 0, "examples": 24,
              "wall_time_s": 0.8, "examples_per_sec": 30.0,
              "metrics": {"err": 0.5}},
             {"kind": "health", "ok": True}]
    path = tmp_path / "hand.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    (trc, tout), (jrc, jout) = _both(
        ["stats", f"--metrics_file={path}", "--last=2"], capsys)
    assert trc == jrc == 0 and tout == jout
    assert "recompiles tagged: 1" in tout and "1 other" in tout


def test_stats_metrics_file_errors(tmp_path, capsys):
    missing = tmp_path / "missing.jsonl"
    assert cli.main(["stats", f"--metrics_file={missing}"]) == 1
    assert "cannot read" in capsys.readouterr().err
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    (trc, tout), (jrc, jout) = _both(
        ["stats", f"--metrics_file={empty}"], capsys)
    assert trc == jrc == 1 and tout == jout
    assert "no records" in tout


def test_stats_cli_prom_format(capsys):
    observe.default_registry().counter("train_steps_total").inc(3)
    assert cli.main(["stats", "--format=prom"]) == 0
    assert "# TYPE train_steps_total counter" in capsys.readouterr().out


def test_stats_cli_pretty_registry(capsys):
    observe.default_registry().counter("book_steps_total",
                                       "steps trained").inc(2, chapter="a")
    assert cli.main(["stats"]) == 0
    out = capsys.readouterr().out
    assert "book_steps_total (counter) — steps trained" in out
    assert "{chapter=a} 2" in out


def test_stats_cli_trace_on_toy_training_run(tmp_path, capsys):
    """A 5-step toy training run, then ``stats --trace out.json``: valid
    Chrome-trace JSON with the trainer's spans."""
    tr = _smallnet()
    tr.train(paddle.batch(lambda: iter(_data(40)), 8), num_passes=1)
    out = str(tmp_path / "out.json")
    assert cli.main(["stats", "--trace", out]) == 0
    assert "perfetto" in capsys.readouterr().out
    with open(out) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("ph") == "X"}
    assert len(names) >= 3
    assert {"train_step", "train_step/dispatch",
            "host_sync", "feed"} <= names


def test_stats_cli_renders_default_request_log(capsys):
    observe.default_request_log().add(
        {"rid": 7, "ttft_s": 0.25, "latency_s": 0.5, "tokens": 16,
         "queue_wait_s": 0.01, "prefill_own_s": 0.02,
         "prefill_stall_s": 0.3, "decode_s": 0.15,
         "cache_hit_frac": 0.5, "finish_reason": "eos"})
    assert cli.main(["stats", "--requests", "5"]) == 0
    out = capsys.readouterr().out
    assert "r7" in out and "dominated by prefill_stall" in out
    assert "cache_hit 50%" in out
    observe.default_request_log().clear()
    assert cli.main(["stats", "--requests", "2"]) == 0
    assert "no completed requests" in capsys.readouterr().out


def _rank_trace(path, rank, skew):
    buf = observe.SpanBuffer(capacity=16)
    for i in range(3):
        buf.add(f"step{i}", 10.0 + skew + i, 0.5)
    return observe.trace_export(str(path), buffer=buf, process_index=rank,
                                align={"barrier0": 10.0 + skew})


def test_stats_merge_matches_the_jax_cli(tmp_path, capsys):
    ranks = []
    for i in range(2):
        _rank_trace(tmp_path / f"r{i}.json", i, 0.25 * i)
        ranks.append(str(tmp_path / f"r{i}.json"))
    outs = {}
    for side, main in (("t", cli.main), ("j", jcli.main)):
        merged = str(tmp_path / f"merged_{side}.json")
        assert main(["stats", "--merge", *ranks, "--trace", merged]) == 0
        line = capsys.readouterr().out
        outs[side] = (line.replace(merged, "OUT"),
                      json.loads(Path(merged).read_text()))
    assert outs["t"] == outs["j"]
    assert "merged 2 traces" in outs["t"][0]


def test_stats_merge_errors(tmp_path, capsys):
    assert cli.main(["stats", "--merge", "a.json"]) == 1
    assert "--merge needs --trace" in capsys.readouterr().err
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli.main(["stats", "--merge", str(bad), "--trace",
                     str(tmp_path / "m.json")]) == 1
    assert "cannot read trace" in capsys.readouterr().err


def test_stats_process_counts_the_steps(tmp_path):
    path = _train_log(tmp_path / "train.jsonl", n=48)
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "stats",
         f"--metrics_file={path}"], cwd=str(REPO), capture_output=True,
        text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "(6 steps, 1 passes)" in p.stdout
