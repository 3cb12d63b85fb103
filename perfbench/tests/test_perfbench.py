"""CPU tests of the benchmark: the traffic, the yardstick's arithmetic,
the plain reference against the port, the files-only extension points,
the result line, and the comparison that decides ``correct`` under
planted faults. Tests that need the card carry the ``gpu`` marker and
skip here.

    python -m pytest perfbench/tests -q
    python -m pytest --noconftest -m gpu perfbench/tests -q   # on a card
"""

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import costs, harness, reference, run, serve, traffic, train
from perfbench import weights

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.benchmark_spec()
CPU = torch.device("cpu")

TINY = {"vocab_size": 97, "n_positions": 128, "n_embd": 64, "n_head": 4,
        "n_layer": 2, "n_inner": None, "resid_pdrop": 0.0,
        "engine": {"slots": 4, "cache_len": 128, "block_size": 16,
                   "num_blocks": 64, "chunk_tokens": 32},
        "training": {"batch": 8, "seq": 32, "learning_rate": 1e-3}}
TINY_MIX = {"clients": 6, "shapes": 64,
            "prompt": {"median": 40, "sigma": 0.6, "min": 8, "max": 100},
            "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 24},
            "greedy_share": 0.5, "temperature": 0.8, "top_k": 5,
            "warm_completions": 6, "profile_steps": 3, "check_requests": 4}


def tiny_cell(name: str) -> dict:
    """The cell's own driver and limits over the tiny model and mix."""
    cell = harness.load_cell(name)
    cell["model"] = TINY
    if cell["driver"] == "serve":
        cell["traffic"] = TINY_MIX
    else:
        cell["traffic"] = {"batches": 8, "profile_steps": 1}
    return cell


def serve_cells():
    return [w["name"] for w in SPEC["workloads"]
            if harness.load_cell(w["name"])["driver"] == "serve"]


def train_cells():
    return [w["name"] for w in SPEC["workloads"]
            if harness.load_cell(w["name"])["driver"] == "train"]


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", serve_cells())
def test_traffic_is_the_seeds_and_within_its_clips(cell):
    mix = harness.load_cell(cell)["traffic"]
    a = traffic.Sequence(mix, 50257, 2 ** 31 + 17)
    b = traffic.Sequence(mix, 50257, 2 ** 31 + 17)
    c = traffic.Sequence(mix, 50257, 5)
    ra = [a.next() for _ in range(300)]
    rb = [b.next() for _ in range(300)]
    rc = [c.next() for _ in range(300)]
    for x, y in zip(ra, rb):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.temperature, x.top_k) == \
            (y.max_new, y.temperature, y.top_k)
    assert any(not np.array_equal(x.prompt[:8], y.prompt[:8])
               for x, y in zip(ra, rc))
    for r in ra + rc:
        assert mix["prompt"]["min"] <= r.prompt.size <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert r.prompt.size + r.max_new <= 1024
        assert r.prompt.dtype == np.int32 and r.prompt.max() < 50257
    # every seed serves the same set of shapes, in its own order
    n = len(a.shapes)
    full = [traffic.Sequence(mix, 97, s) for s in (1, 2)]
    shapes = [sorted((r.prompt.size, r.max_new, r.greedy)
                     for r in (q.next() for _ in range(n))) for q in full]
    assert shapes[0] == shapes[1] == sorted(traffic.shapes(mix))
    greedy = sum(g for _, _, g in traffic.shapes(mix))
    assert greedy == round(mix["greedy_share"] * n)


def test_quantile_lengths_follow_the_lognormal():
    spec = {"median": 256, "sigma": 0.8, "min": 16, "max": 768}
    q = traffic.quantile_lengths(spec, 1001)
    assert q[500] == 256 and q.min() >= 16 and q.max() == 768
    assert np.all(np.diff(q) >= 0)


def test_prefill_keys_cover_every_chunk():
    mix = {"prompt": {"min": 16, "max": 300}}
    keys = traffic.prefill_keys(mix, 256, (8, 16, 32, 64, 128, 256), 16)
    assert (0, 16) in keys and (0, 256) in keys and (256, 64) in keys
    assert (256, 128) not in keys          # 300 - 256 = 44 at most
    assert all(off % 256 == 0 for off, _ in keys)


def test_train_batches_are_the_seeds():
    a = traffic.train_batches(torch, 2 ** 33 + 1, 3, 2, 8, 97, CPU)
    b = traffic.train_batches(torch, 2 ** 33 + 1, 3, 2, 8, 97, CPU)
    assert a.shape == (3, 2, 9) and a.dtype == torch.int32
    assert torch.equal(a, b) and int(a.max()) < 97
    assert not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# the yardstick's arithmetic, against hand counts
# ---------------------------------------------------------------------------

SMALL = weights.Sizes(vocab=10, d_model=4, n_heads=2, n_layers=3, d_ff=8,
                      max_len=16, dropout=0.0)


def test_model_flops_by_hand():
    # per layer: qkv 4x12, out 4x4, mlp 4x8 + 8x4 = 48+16+64 = 128; x3
    # layers = 384, + the head 4x10 = 424
    assert costs.matmul_params(SMALL) == 424
    # two rows at positions 0 and 2: 2*424*2 + 4*3*2*2*(1 + 3) = 1792
    assert costs.decode_step_flops(SMALL, [0, 2]) == 1696 + 192
    # chunk of 3 after 2: blocks 2*384*3 = 2304, head 2*4*10 = 80, pairs
    # 3*2 + 6 = 12 -> 4*3*2*2*12 = 576
    assert costs.prefill_chunk_flops(SMALL, 2, 3) == 2304 + 80 + 576
    # B=2, T=3: 6*424*6 = 15264; pairs 2*6 = 12 -> 12*3*2*2*12 = 1728
    assert costs.train_step_flops(SMALL, 2, 3) == 15264 + 1728


def test_kernel_work_by_hand():
    # decode rows at 0 and 17, block 16: seen 1 + 18 = 19, pages 1 + 2
    b, f = costs.decode_attention_work(SMALL, [0, 17], 16)
    per_layer = 2 * 2 * 2 * 2 + 2 * 19 * 2 * 2 * 2 + 3 * 4 + 2 * 4 \
        + 2 * 2 * 2 * 4
    assert b == 3 * per_layer and f == 3 * 4 * 19 * 2 * 2
    # chunk of 3 after 32 context tokens
    b, f = costs.chunk_prefill_work(SMALL, 32, 3, 16)
    per_layer = 3 * 2 * 2 * 2 + 2 * 3 * 2 * 2 * 2 + 2 * 32 * 2 * 2 * 2 \
        + 2 * 4 + 3 * 2 * 2 * 4
    assert b == 3 * per_layer and f == 3 * 4 * (96 + 6) * 2 * 2
    # flash at B=1, T=4: BH = 2, n = 2*4*2 = 16, pairs 2*10 = 20
    b, f = costs.flash_fwd_work(SMALL, 1, 4)
    assert (b, f) == (3 * (4 * 16 * 2 + 2 * 4 * 4), 3 * 4 * 2 * 20)
    b, f = costs.flash_bwd_work(SMALL, 1, 4)
    assert (b, f) == (3 * (8 * 16 * 2 + 2 * 4 * 4), 3 * 10 * 2 * 20)


def test_roofline_is_the_larger_bound_over_the_time():
    t = costs.bound_seconds(3.35e12, 0.0)
    assert t == pytest.approx(1.0)
    assert costs.roofline_percent(3.35e12, 989e12 * 2, 4.0) == \
        pytest.approx(50.0)
    assert costs.roofline_percent(1.0, 1.0, 0.0) is None


# ---------------------------------------------------------------------------
# the plain reference against the port, at a tiny size
# ---------------------------------------------------------------------------

def test_reference_forward_and_loss_match_the_port():
    from paddle_tpu_torch.models import transformer as tt
    sz = weights.sizes(TINY)
    cfg = tt.TransformerConfig(vocab=sz.vocab, d_model=sz.d_model,
                               n_heads=sz.n_heads, n_layers=sz.n_layers,
                               d_ff=sz.d_ff, max_len=sz.max_len,
                               dtype=torch.float32)
    params = weights.tree(torch, sz, 123, CPU)
    tok = torch.randint(0, sz.vocab, (2, 24), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    with torch.no_grad():
        got = tt.forward(params, tok, cfg)
        want = reference.logits(weights.flat(params), tok, sz)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_reference_adam_steps_match_the_port():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import transformer as tt
    sz = weights.sizes(TINY)
    cfg = tt.TransformerConfig(vocab=sz.vocab, d_model=sz.d_model,
                               n_heads=sz.n_heads, n_layers=sz.n_layers,
                               d_ff=sz.d_ff, max_len=sz.max_len,
                               dtype=torch.float32)
    batches = traffic.train_batches(torch, 9, 2, 4, 16, sz.vocab, CPU)
    params = weights.tree(torch, sz, 9, CPU)
    for v in weights.flat(params).values():
        v.requires_grad_(True)
    adam = topt.Adam(learning_rate=1e-3)
    state = adam.tree_init_state(params)
    losses = []
    for i in range(2):
        b = batches[i]
        loss = tt.lm_loss(params, b[:, :16], b[:, 1:], cfg)
        loss.backward()
        losses.append(float(loss.detach()))
        _, state = adam.tree_update(i, topt.take_grads(params), params,
                                    state)
    w = weights.flat(weights.tree(torch, sz, 9, CPU))
    ref = reference.train_steps(w, list(batches), sz, 1e-3, rows=3)
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    # 2 steps of 1e-3 move a leaf by up to 2e-3; where a gradient is
    # near 0, Adam's m / sqrt(v) turns fp32 rounding into ~1e-5 of it
    for k, v in weights.flat(params).items():
        assert torch.allclose(v.detach(), w[k].detach(), atol=1e-5), k


def test_fp8_control_rounds_per_tensor_and_passes_e5m2_gradients():
    x = torch.tensor([[1.0, 0.3], [-448.0 / 3, 2.0]], requires_grad=True)
    q = reference._q(x, True)
    assert float(q[1, 0]) == pytest.approx(-448.0 / 3, rel=1e-6)
    assert q[0, 1] != x[0, 1]               # e4m3 keeps 3 mantissa bits
    assert abs(float(q[0, 1]) - 0.3) < 0.3 / 8
    g = torch.tensor([[1.0, 0.3], [1000.0, 2.0]])
    q.backward(g)
    assert float(x.grad[1, 0]) == pytest.approx(1000.0, rel=1e-6)
    assert x.grad[0, 1] != 0.3
    assert abs(float(x.grad[0, 1]) - 0.3) < 0.3 / 4   # e5m2: 2 bits
    assert reference._q(x, False) is x


# ---------------------------------------------------------------------------
# the extension points are files and entries
# ---------------------------------------------------------------------------

def test_a_new_cell_config_and_metric_are_found_as_files(tmp_path):
    base = tmp_path / "perfbench"
    for d in ("cells", "configs", "metrics"):
        shutil.copytree(harness.HERE / d, base / d)
    existing = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    model = dict(TINY, n_layer=1)
    (base / "configs" / "tiny-model.json").write_text(json.dumps(model))
    (base / "cells" / "tiny-chat.json").write_text(json.dumps(
        {"config": "tiny-model", "driver": "serve", "traffic": TINY_MIX,
         "limits": {"max_gap": 0.5}}))
    (base / "metrics" / "clients_seen.py").write_text(
        "def read(ctx):\n    return len(ctx['occupancy'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "tiny-chat", "config": "tiny-model",
                              "traffic": "tiny-chat", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "xl-chat" in m.get("workloads", []):
            m["workloads"].append("tiny-chat")
    spec["per_layer"].append({"name": "clients_seen", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine scheduler",
                              "moves": "serve_tokens_per_s",
                              "workloads": ["tiny-chat"]})
    cell = harness.load_cell("tiny-chat", base)
    assert cell["model"]["n_layer"] == 1 and cell["driver"] == "serve"
    names = harness.per_layer_names(spec, "tiny-chat")
    assert "clients_seen" in names and "slot_occupancy" in names
    assert "clients_seen" not in harness.per_layer_names(spec, "xl-chat")
    assert "serve_tokens_per_s" in harness.end_to_end_names(spec,
                                                            "tiny-chat")
    got = harness.read_metrics(["clients_seen", "slot_occupancy"],
                               {"occupancy": [2, 4], "slots": 4}, base)
    assert got == {"clients_seen": 2.0, "slot_occupancy": 75.0}
    for p, data in existing.items():          # nothing there was edited
        assert p.read_bytes() == data


def test_every_metric_has_its_reader_and_every_cell_its_files():
    for m in SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"])), m["name"]
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert (harness.HERE / f"{cell['driver']}.py").is_file()
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()


# ---------------------------------------------------------------------------
# BENCHMARK.json against the contract's rules that a file can show
# ---------------------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expansion|experts_per|n_embd|n_inner")


def test_benchmark_json_keeps_the_contract():
    s = SPEC
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(s["paths"]) <= 16 and len(s["command"]) <= 32
    for w in s["command"]:
        assert not w.startswith("/") and ".." not in w
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    pairs = set()
    fours = 0
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        fours += w["chips"] == 4
    assert fours <= max(1, len(s["workloads"]) // 4)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in s["workloads"]:
        n = w["name"]
        reported = harness.end_to_end_names(s, n)
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.per_layer_names(s, n)
    # every metric moved by a roofline is moved by an mfu beside it
    moved = {m["moves"] for m in s["per_layer"]
             if m["name"].endswith("_roofline")}
    assert moved <= {m["moves"] for m in s["per_layer"]
                     if "mfu" in m["name"]}


# ---------------------------------------------------------------------------
# the result line and the module check
# ---------------------------------------------------------------------------

class _FakeCuda:
    @staticmethod
    def get_device_name(i=0):
        return "NVIDIA H100 80GB HBM3"


class _FakeTorch:
    cuda = _FakeCuda


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    cell = harness.load_cell("xl-chat")
    ctx = {"model": weights.sizes(cell["model"]), "slots": 128,
           "occupancy": [64, 96], "captures": 0, "queue_wait_s": [0.1, 0.2],
           "decode_s": [0.02, 0.03], "window_s": 2.0,
           "decodes": [np.array([5, 9])], "prefills": [(0, 256)],
           "prefill_own_s": [0.01], "prompt_lens": [256],
           "chunk_tokens": 256, "block_size": 16,
           "trace": {"busy_s": 0.5, "window_s": 1.0,
                     "kernel_s": {"decode": 1e-3, "prefill": 1e-3},
                     "decodes": [np.array([5, 9])], "prefills": [(0, 256)],
                     "breakdown": {"device_ops": [["k", 0.1]],
                                   "idle_gaps": [["h", 0.2]]}}}
    out = {"correct": True, "attempted": 10, "failed": 0,
           "e2e": {"serve_tokens_per_s": 1.0, "ttft_p95_ms": 2.0,
                   "tpot_p95_ms": 3.0, "setup_s": 4.0},
           "ctx": ctx, "trace": ctx["trace"], "peak_bytes": 123,
           "checks": {"max_gap": (0.1, 0.5), "unfinished": (0, 0)}}
    line = run.compose(_FakeTorch, SPEC, cell, out, trace, 1)
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    want = (harness.per_layer_names(SPEC, "xl-chat") if trace
            else harness.end_to_end_names(SPEC, "xl-chat"))
    assert set(line["metrics"]) <= set(want)
    if trace:
        assert dev["busy_s"] == 0.5 and dev["window_s"] == 1.0
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert "decode_attn_roofline" in line["metrics"]
    else:
        assert set(line["metrics"]) == set(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert line["check"]["max_gap"] == {"value": 0.1, "limit": 0.5}
    json.dumps(line)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"paddle_tpu_torch": 1, "paddle_tpu_torch.serving": 1,
            "jaxlib.xla": 1, "paddle_tpu.models": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == ["jaxlib.xla",
                                               "paddle_tpu.models"]


REHEARSAL = """
import sys, time, torch
sys.path.insert(0, {root!r})
from perfbench import harness, serve, train
from perfbench.tests.test_perfbench import tiny_cell
for name in ("xl-chat", "large-train"):
    cell = tiny_cell(name)
    harness.load_driver(cell["driver"]).run(
        torch, cell, 3, 0.5, False, torch.device("cpu"), time.perf_counter())
print(harness.forbidden_modules())
"""


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package():
    done = subprocess.run([sys.executable, "-c",
                           REHEARSAL.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "xl-chat", "--seed", "5", "--seconds", "1"],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and done.stdout == ""


# ---------------------------------------------------------------------------
# correct: true on the sound path, false under each planted fault
# ---------------------------------------------------------------------------

def _serve(cell_name, fault=None):
    return serve.run(torch, tiny_cell(cell_name), 2 ** 31 + 3, 1.0, False,
                     CPU, time.perf_counter(), fault=fault)


def _train(cell_name, fault=None):
    return train.run(torch, tiny_cell(cell_name), 2 ** 31 + 3, 0.5, False,
                     CPU, time.perf_counter(), fault=fault)


@pytest.mark.parametrize("cell", serve_cells())
def test_serving_sound_run_is_correct(cell):
    out = _serve(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["sample_tokens"] > 0


def _altered_tokens(eng):
    """A token altered where it is produced: every decode step's ids
    shifted by one."""
    decode, vocab = eng._decode_fn, eng.cfg.vocab

    def broken(*args):
        nxt, cache = decode(*args)
        return (nxt + 1) % vocab, cache
    eng._decode_fn = broken


def _half_batch(eng):
    """Half of the batch left out: the decode step's second half of the
    slots gets the first half's ids."""
    decode = eng._decode_fn

    def broken(*args):
        nxt, cache = decode(*args)
        h = nxt.shape[0] // 2
        return torch.cat([nxt[:h], nxt[:nxt.shape[0] - h]]), cache
    eng._decode_fn = broken


@pytest.mark.parametrize("cell", serve_cells())
@pytest.mark.parametrize("fault", [_altered_tokens, _half_batch])
def test_serving_fault_is_not_correct(cell, fault):
    out = _serve(cell, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", train_cells())
def test_training_sound_run_is_correct(cell):
    out = _train(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


def _unchanged_state(step):
    """A step that returns its state unchanged: no update is applied."""
    def update(i, grads, params, state):
        return params, state
    step.adam.tree_update = update


def _half_batch_loss(step):
    """Half of the batch left out, the mean taken over the rest."""
    tt = step.tt

    class Half:
        @staticmethod
        def lm_loss(params, tokens, targets, cfg):
            h = tokens.shape[0] // 2
            return tt.lm_loss(params, tokens[:h], targets[:h], cfg)
    step.tt = Half


@pytest.mark.parametrize("cell", train_cells())
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch_loss])
def test_training_fault_is_not_correct(cell, fault):
    out = _train(cell, fault)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------------------
# on the card: the control fails the cell's limits at the cell's own size
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_the_limits_on_the_card(card, cell):
    c = harness.load_cell(cell)
    out = harness.load_driver(c["driver"]).run(
        torch, c, 7001, 3.0, False, card, time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    if c["driver"] == "serve":
        assert out["control"] > c["limits"]["max_gap"]
    else:
        for reading in out["control"].values():
            assert any(reading[k] > c["limits"][k] for k in reading)
