"""The port's compile tracker and step programs against ``paddle_tpu``'s,
on the CPU.

- ``observe/compile_tracker``: the same calls give the JAX tracker's
  signatures, miss counts, seconds and miss records;
- the paged engine's ``compile_counts()`` equals the JAX engine's over
  ``tests/test_paged_engine.py``'s chunk walk (one program per (chunk
  bucket, page-vector length) pair, one for decode), for model-dtype (fp32),
  int8 and int4 pools;
- what capture needed of the step functions, each bitwise what it was:
  the decode step's masked write with inactive rows whose page table
  points into a live block (the pool is JAX's byte for byte outside the
  active rows' targets), prefill with ``length`` as a 0-d tensor, the
  sampler's plain version with a tensor seed;
- ``core/graphs.StepProgram`` on the CPU: it runs its function and
  counts signatures; a replay's launch counts add up.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import ragged as jragged
from paddle_tpu.models import transformer as jt
from paddle_tpu.observe import compile_tracker as jct
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu_torch.core import graphs
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import compile_tracker as tct
from paddle_tpu_torch.observe import metrics as tmetrics
from paddle_tpu_torch.ops import kernels, prng
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.serving import PagedDecodeEngine

torch.set_num_threads(1)

# tests/test_paged_engine.py's CFG
KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
JCFG = jt.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = tt.TransformerConfig(dtype=torch.float32, **KW)
BS = 8
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    TCFG, device="cpu")


def _calls():
    """Argument tuples of the kinds the engines pass: arrays, numpy
    scalars, static ints, a parameter dict, None."""
    a = np.zeros((1, 16), np.int32)
    tree = {"w": np.ones((2, 3), np.float32), "b": {"x": np.zeros(4, bool)}}
    return [(tree, a, np.int32(5), np.zeros(3, np.int32), 7),
            (tree, a, np.int32(9), np.zeros(3, np.int32), 7),     # same
            (tree, np.zeros((1, 8), np.int32), np.int32(5),
             np.zeros(3, np.int32), 7),
            (tree, a, np.float32(5), np.zeros(3, np.int32), 7),
            (tree, a, np.int32(5), np.zeros(3, np.int32), 8),
            (tree, a, np.int32(5), np.zeros(4, np.int32), None)]


def test_arg_signature_matches_jax():
    for args in _calls():
        assert tct.arg_signature(*args) == jct.arg_signature(*args)
        assert tct.arg_signature(args, {}) == jct.arg_signature(args, {})
    # tensors sign like the JAX arrays of the same shape and dtype
    for dt, jdt in ((torch.int32, jnp.int32), (torch.float32, jnp.float32),
                    (torch.bool, jnp.bool_)):
        assert (tct.arg_signature(torch.zeros(2, 5, dtype=dt))
                == jct.arg_signature(jnp.zeros((2, 5), jdt)))


def test_tracker_matches_jax():
    logs = []
    for mod in (tct, jct):
        tr = mod.CompileTracker(storm_threshold=3)
        log = [tr.record("f", mod.arg_signature(*args),
                         0.5 if i < 3 else None)
               for i, args in enumerate(_calls() * 2)]
        log += [tr.count("f"), tr.count(), tr.count("g"),
                tr.compile_seconds("f"), tr.compile_seconds(),
                [m["signature"] for m in tr.misses("f")],
                [m["miss_index"] for m in tr.misses("f")],
                {k: (v["count"], v["compile_seconds"])
                 for k, v in tr.snapshot().items()}]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][:12] == [True, False, True, True, True, True] + [False] * 6


def test_track_calls_and_storm_warning(caplog):
    tr = tct.CompileTracker(storm_threshold=2)
    jtr = jct.CompileTracker(storm_threshold=2)
    wrapped = tct.track_compiles(lambda x, k=0: x.shape, "f", tr)
    jwrapped = jct.track_compiles(lambda x, k=0: x.shape, "f", jtr)
    before = tmetrics.default_registry().get(
        "compile_cache_misses_total").value(fn="f")
    with caplog.at_level(logging.WARNING,
                         logger="paddle_tpu_torch.observe.compile"):
        for n in (1, 2, 2, 3, 4, 4):
            for w in (wrapped, jwrapped):
                w(np.zeros(n, np.float32), k=n % 2)
    assert wrapped.tracker is tr and tr.count("f") == jtr.count("f") == 4
    assert tmetrics.default_registry().get(
        "compile_cache_misses_total").value(fn="f") == before + 4
    assert tmetrics.default_registry().get(
        "compile_wall_seconds_total").value(fn="f") > 0
    storms = [r for r in caplog.records if "recompile storm" in r.message]
    assert len(storms) == 2                   # at 2 and at 4 programs
    tr.clear()
    assert tr.count() == 0 and tr.snapshot() == {}


def _walk_programs(eng, lens):
    """The (chunk bucket, page-vector length) pairs the scheduler's
    chunk walk reaches for prompts of ``lens`` (the JAX test's walk)."""
    progs = set()
    for n in lens:
        off = 0
        while off < n:
            c = min(n - off, eng.chunk_tokens)
            b = jragged.bucket_length(c, eng.buckets)
            progs.add((b, off // eng.block_size + -(-b // eng.block_size)))
            off += c
    return progs


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_engine_compile_counts_match_jax(params, kv_dtype, rng):
    """``test_paged_engine.py``'s ``test_compile_once_per_chunk_shape_plus_
    decode`` walk on both engines: the same programs, the same greedy
    ids."""
    jp, tp = params
    lens = (3, 26, 9, 12)
    prompts = [rng.randint(0, 40, n).astype(np.int32) for n in lens]
    kw = dict(batch=2, cache_len=32, block_size=BS, chunk_tokens=8, seed=0,
              kv_dtype=kv_dtype)
    engines = (JaxEngine.from_params(jp, JCFG, pallas="off",
                                     decode_flops=None,
                                     tracker=jct.CompileTracker(), **kw),
               PagedDecodeEngine.from_params(tp, TCFG, device="cpu", **kw))
    counts, outs = [], []
    for eng in engines:
        reqs = [eng.submit(p, max_new=4) for p in prompts]
        eng.run_until_idle()
        counts.append(eng.compile_counts())
        outs.append([r.tokens for r in reqs])
    want = len(_walk_programs(engines[1], lens))
    assert want == 4
    assert counts[0] == counts[1] == {"prefill": want, "decode": 1}
    assert outs[0] == outs[1]
    health = engines[1].health()
    assert health["compile_counts"] == counts[1]
    assert health["compile_seconds"]["decode"] > 0


def _pool(rng, kv_dtype):
    """A JAX pool of 8 blocks filled with random bytes, as numpy."""
    pool = jax.tree_util.tree_map(np.asarray, jt.init_block_pool(
        JCFG, 8, BS, **({"kv_dtype": kv_dtype} if kv_dtype else {})))
    for n, a in pool.items():
        pool[n] = (rng.randint(-7, 8, a.shape).astype(np.int8)
                   if a.dtype == np.int8 else rng.rand(*a.shape)
                   .astype(np.float32))
    return pool


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_decode_inactive_rows_alias_a_live_block(params, kv_dtype, rng):
    """Row 0 is active and writes position 2 of block 0; rows 1 and 2
    are inactive with all-zero page tables, row 1 at the same position
    (the same target) and row 2 at position 7 of block 0 (a live
    request's row). Outside row 0's target the pool is JAX's byte for
    byte; the target itself holds JAX's values (codes exactly, floats
    within 1e-5); the logits of row 0 agree."""
    jp, tp = params
    pool = _pool(rng, kv_dtype)
    pages = np.zeros((3, 4), np.int32)
    pages[0] = [0, 3, 5, 1]
    tokens = np.asarray([5, 9, 11], np.int32)
    pos = np.asarray([2, 2, 7], np.int32)
    active = np.asarray([True, False, False])
    jl, jout = jt.decode_step_paged(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(pages), JCFG, block_size=BS, pallas="off")
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tl, _ = tt.decode_step_paged(
        tp, tpool, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(pages), TCFG,
        block_size=BS)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=ATOL)
    target = 0 * BS + 2
    for n in pool:
        got, want = tpool[n].numpy(), np.asarray(jout[n])
        keep = np.ones(got.shape[2], bool)
        keep[target] = False
        assert got[:, :, keep].tobytes() == want[:, :, keep].tobytes(), n
        assert not np.array_equal(got[:, :, target], pool[n][:, :, target])
        if got.dtype == np.int8:
            assert np.abs(got[:, :, target].astype(int)
                          - want[:, :, target]).max() <= 1, n
        else:
            np.testing.assert_allclose(got[:, :, target],
                                       want[:, :, target], rtol=1e-5,
                                       atol=ATOL)


def test_decode_with_no_active_row_writes_nothing(params, rng):
    _, tp = params
    pool = _pool(rng, "int8")
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tt.decode_step_paged(
        tp, tpool, torch.tensor([5, 9], dtype=torch.int32),
        torch.tensor([2, 7], dtype=torch.int32),
        torch.tensor([False, False]), torch.zeros((2, 4), dtype=torch.int32),
        TCFG, block_size=BS)
    for n in pool:
        assert np.array_equal(tpool[n].numpy(), pool[n])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_length_as_tensor_bitwise(params, kv_dtype, rng):
    """``length`` as a 0-d int32 tensor (what a captured program is
    given) and as an int give the same logits and pool, bit for bit."""
    _, tp = params
    pool = _pool(rng, kv_dtype)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = rng.randint(0, 40, 11)
    pages = np.asarray([4, 2, 6], np.int32)           # 8 context tokens
    outs = []
    for length in (11, torch.tensor(11, dtype=torch.int32)):
        tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
        lg, _ = tt.prefill_into_blocks(
            tp, tpool, torch.from_numpy(padded), length,
            torch.from_numpy(pages), TCFG, block_size=BS)
        outs.append((lg, tpool))
    assert torch.equal(outs[0][0], outs[1][0])
    for n in pool:
        assert torch.equal(outs[0][1][n], outs[1][1][n])


@pytest.mark.parametrize("stream", kdecode.STREAMS)
def test_fused_sample_plain_tensor_seed_bitwise(stream, rng):
    x = torch.from_numpy(rng.randn(3, 200).astype(np.float32))
    temp = torch.tensor([0.0, 0.8, 1.3])
    topk = torch.tensor([0, 50, 0], dtype=torch.int32)
    for seed in (0, 12345, -7, 2 ** 31 - 1):
        want = kdecode.fused_sample_plain(x, seed, temp, topk, stream)
        got = kdecode.fused_sample_plain(
            x, torch.tensor(seed, dtype=torch.int32), temp, topk, stream)
        assert torch.equal(got, want)
        assert torch.equal(
            kdecode.fused_sample(x, torch.tensor(seed, dtype=torch.int32),
                                 temp, topk, stream), want)
        assert torch.equal(prng.prng_key(torch.tensor(seed,
                                                      dtype=torch.int32)),
                           prng.prng_key(seed))


def test_step_program_on_the_cpu_runs_and_counts():
    seen = []

    def fn(tree, tokens, length, scale):
        seen.append((tokens.dtype, tuple(length.shape), length.dtype,
                     scale))
        return tokens.sum() * length + tree["w"].sum()

    tracker = tct.CompileTracker()
    prog = graphs.StepProgram(fn, "f", tracker)
    assert prog.raw is fn and prog.graphs == 0
    tree = {"w": torch.ones(3)}
    out = prog(tree, np.arange(4, dtype=np.int32), np.int32(2), 1.5)
    assert out.item() == 15.0
    prog(tree, np.arange(4, dtype=np.int32), np.int32(3), 1.5)   # same key
    prog(tree, np.arange(5, dtype=np.int32), np.int32(3), 1.5)   # new shape
    prog(tree, np.arange(5, dtype=np.int32), np.int32(3), 2.5)   # static
    assert tracker.count("f") == 3 and prog.graphs == 0   # no card: no graph
    assert seen[0] == (torch.int32, (), torch.int32, 1.5)
    with pytest.raises(TypeError, match="dtype"):
        prog(tree, np.arange(4, dtype=np.float64), np.int32(2), 1.5)


def test_add_launches_names_every_branch():
    kernels.reset_launches()
    kernels.add_launches({"fused_sample": 2, "fused_sample.threefry": 1,
                          "flash_decode_attention.int8": 3,
                          "paged_span_write": 4})
    counts = kernels.launch_counts()
    assert counts["fused_sample"] == 2
    assert counts["fused_sample.threefry"] == 1
    assert counts["flash_decode_attention.int8"] == 3
    assert counts["paged_span_write"] == 4
    assert sum(counts.values()) == 10
    kernels.add_launches({k: -v for k, v in counts.items()})
    assert not any(kernels.launch_counts().values())
