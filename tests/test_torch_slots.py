"""The port's row-arena serving path against ``paddle_tpu``'s, on the CPU.

- ``prefill``, ``decode_step``, ``decode_step_slots`` and
  ``prefill_into_slot`` on the same inputs as the JAX functions, over
  fp32 and bf16 models and int8 weights (the JAX lockstep functions take
  the int8 tree dequantized, as ``generate`` and the v2 artifact give it
  to them): logits and arenas;
- the port's ``decode_step_slots`` is bitwise its own ``decode_step`` at
  equal positions, and inactive rows and other positions keep their
  bytes;
- ``prefill_into_slot`` against JAX's on the SAME padded input (the JAX
  test that sets a padded prefill against a batched one,
  ``test_prefill_into_slot_matches_batched_prefill``, compares two GEMM
  row counts bitwise and fails on some hosts; it is not the reference);
- the slot engine against the JAX ``DecodeEngine`` (its kernels in
  interpret mode, so both decode tails draw the hashed stream) step by
  step, greedy and sampled, and the JAX engine tests' properties:
  engine == ``generate``, mid-flight admission, EOS recycling, one
  program per bucket plus decode, the submit guards with their rejection
  counters, unseeded engines differ; ``health()`` and the metric names.

Small configs (2 layers, d_model 32, vocab 64; MHA with learned
positions, GQA with RoPE). Tolerances: fp32 (and int8 weights on an
fp32 model) logits and arena rows 1e-4 absolute (the libraries sum in
other orders, ~1e-6 seen). bf16: layer 0's k/v bitwise (the same
operations on the same embedding rows), later layers' k/v and the
logits within 2^-6 relative L2: where two fp32 sums differ in their
last bits, an activation can round to the neighbouring bf16 value
(2^-8 relative), and such flips in layer 0's attention and MLP outputs
reach layer 1 and the head (0.5-0.7 % seen). Ids exact; untouched
arena bytes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jt
from paddle_tpu.observe.compile_tracker import CompileTracker as JaxTracker
from paddle_tpu.ops import q8 as jq8
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.serving import DecodeEngine

# the suite runs several test processes side by side on a few cores:
# one intra-op thread keeps these tiny-shape tests from crowding the
# cores the other processes' JAX tests use
torch.set_num_threads(1)

ATOL = 1e-4
BF16_REL_L2 = 2.0 ** -6
CONFIGS = {"mha-learned": dict(n_kv_heads=0, use_rope=False),
           "gqa-rope": dict(n_kv_heads=2, use_rope=True)}
KINDS = ("fp32", "bf16", "int8")


def _model(name, kind, seed=0):
    """(jcfg, tcfg, JAX params as the quantized or plain tree, JAX params
    as the lockstep functions take them, the port's params)."""
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=64, **CONFIGS[name])
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if kind == "bf16"
                else (jnp.float32, torch.float32))
    jcfg = jt.TransformerConfig(dtype=jdt, **kw)
    tcfg = tt.TransformerConfig(dtype=tdt, **kw)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    live = jp
    if kind == "int8":
        jp = jlm.quantize_lm_params(jp)
        live = jq8.dequantize_tree(jp)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, live, tt.params_from_numpy(tree, tcfg,
                                                      device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close_logits(got, want, kind):
    got, want = _np(got), np.asarray(want, np.float32)
    if kind == "bf16":
        assert _rel_l2(got, want) <= BF16_REL_L2
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _close_cache(got, want, kind):
    got = tt.cache_to_numpy(got)
    for n in ("k", "v"):
        g, w = got[n], np.asarray(want[n], np.float32)
        if kind == "bf16":
            np.testing.assert_array_equal(g[0], w[0])
            assert _rel_l2(g[1:], w[1:]) <= BF16_REL_L2, n
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 64, shape).astype(np.int32)


def _arena(jcache, tcfg):
    return tt.cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                               tcfg, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(name, kind):
    jcfg, tcfg, _, live, tp = _model(name, kind)
    prompt = _tokens(1, 3, 7)
    jl, jc = jt.prefill(live, jnp.asarray(prompt), jcfg, 20)
    tl, tc = tt.prefill(tp, torch.from_numpy(prompt), tcfg, 20)
    assert tl.shape == (3, 64) and tc["k"].shape == jc["k"].shape
    assert tc["k"].dtype == tcfg.dtype
    _close_logits(tl, jl, kind)
    _close_cache(tc, jc, kind)
    assert not tc["k"][:, :, 7:].any() and not tc["v"][:, :, 7:].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match_jax(name, kind):
    """From one JAX prefill's arena: a lockstep step at the prompt's end
    and a slot step with mixed positions and one inactive row, each
    against its JAX function (the slot step takes the int8 tree
    natively in both packages)."""
    jcfg, tcfg, jp, live, tp = _model(name, kind)
    prompt = _tokens(2, 3, 6)
    _, jc = jt.prefill(live, jnp.asarray(prompt), jcfg, 20)
    tok = _tokens(3, 3)
    jl, jc1 = jt.decode_step(live, jc, jnp.asarray(tok), jnp.int32(6), jcfg)
    tl, tc1 = tt.decode_step(tp, _arena(jc, tcfg), torch.from_numpy(tok), 6,
                             tcfg)
    _close_logits(tl, jl, kind)
    _close_cache(tc1, jc1, kind)
    pos = np.asarray([6, 3, 9], np.int32)
    active = np.asarray([True, False, True])
    jl, jc2 = jt.decode_step_slots(jp, jc, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(active),
                                   jcfg)
    tl, tc2 = tt.decode_step_slots(tp, _arena(jc, tcfg),
                                   torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(active), tcfg)
    _close_logits(tl[active], np.asarray(jl, np.float32)[active], kind)
    _close_cache(tc2, jc2, kind)


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_step_bitwise_equals_lockstep_step(name, kind):
    """At equal positions the slot step's logits and arena are bitwise
    the lockstep step's (JAX's ``test_vector_pos_decode_bitwise_matches_
    lockstep``)."""
    _, tcfg, _, _, tp = _model(name, kind)
    prompt = torch.from_numpy(_tokens(4, 3, 6))
    logits, cache = tt.prefill(tp, prompt, tcfg, 20)
    tok = torch.argmax(logits, -1).to(torch.int32)
    l1, c1 = tt.decode_step(tp, {n: c.clone() for n, c in cache.items()},
                            tok, 6, tcfg)
    l2, c2 = tt.decode_step_slots(tp, {n: c.clone() for n, c in cache.items()},
                                  tok, torch.full((3,), 6, dtype=torch.int32),
                                  torch.ones(3, dtype=torch.bool), tcfg)
    assert torch.equal(l1, l2)
    for n in ("k", "v"):
        assert torch.equal(c1[n].view(torch.uint8 if kind == "bf16"
                                      else torch.int32).flatten(),
                           c2[n].view(torch.uint8 if kind == "bf16"
                                      else torch.int32).flatten())


def test_inactive_slots_not_written():
    """An inactive row keeps every byte; each active row writes its own
    position only (JAX's ``test_inactive_slots_not_written``), with an
    inactive row standing at the last position."""
    _, tcfg, _, _, tp = _model("gqa-rope", "fp32")
    _, cache = tt.prefill(tp, torch.from_numpy(_tokens(5, 4, 6)), tcfg, 20)
    for n, c in cache.items():              # no zero rows left
        c.copy_(torch.randn(c.shape, generator=torch.Generator()
                            .manual_seed(1)))
    before = {n: c.clone() for n, c in cache.items()}
    _, after = tt.decode_step_slots(
        tp, cache, torch.zeros(4, dtype=torch.int32),
        torch.tensor([6, 3, 9, 19], dtype=torch.int32),
        torch.tensor([True, False, True, False]), tcfg)
    for n in ("k", "v"):
        a, b = after[n], before[n]
        for row in (1, 3):
            assert torch.equal(a[:, row].view(torch.int32),
                               b[:, row].view(torch.int32))
        for row, p in ((0, 6), (2, 9)):
            assert not torch.equal(a[:, row, p], b[:, row, p])
            keep = [t for t in range(20) if t != p]
            assert torch.equal(a[:, row, keep].view(torch.int32),
                               b[:, row, keep].view(torch.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_into_slot_matches_jax(name, kind):
    """One prompt right-padded to its bucket into row 1 of a zero arena,
    in both packages on the same padded input: the gathered logits and
    the written row agree, the other rows stay zero; the gathered
    position's logits also equal a lockstep prefill of the prompt
    alone."""
    jcfg, tcfg, _, live, tp = _model(name, kind)
    prompt = _tokens(6, 1, 6)
    padded = np.pad(prompt, ((0, 0), (0, 2)))
    jarena = jt.init_cache(jcfg, 3, 24)
    jl, jarena = jt.prefill_into_slot(live, jarena, jnp.asarray(padded),
                                      jnp.int32(6), jnp.int32(1), jcfg)
    tarena = tt.init_cache(tcfg, 3, 24, device="cpu")
    tl, tarena = tt.prefill_into_slot(
        tp, tarena, torch.from_numpy(padded),
        torch.tensor(6, dtype=torch.int32), torch.tensor(1, dtype=torch.int32),
        tcfg)
    assert tl.shape == (1, 64)
    _close_logits(tl, jl, kind)
    _close_cache(tarena, jarena, kind)
    for n in ("k", "v"):
        assert not tarena[n][:, 0].any() and not tarena[n][:, 2].any()
        assert not tarena[n][:, 1, 8:].any()
    alone, _ = tt.prefill(tp, torch.from_numpy(prompt), tcfg, 8)
    _close_logits(tl, _np(alone), kind)


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------

ENGINE = dict(batch=2, cache_len=32, buckets=(8, 16))


def _engines(name="gqa-rope", kind="fp32", seed=0, **kw):
    jcfg, tcfg, jp, _, tp = _model(name, kind)
    ekw = dict(ENGINE, seed=seed, **kw)
    return (JaxEngine.from_params(jp, jcfg, pallas="interpret",
                                  tracker=JaxTracker(), **ekw),
            DecodeEngine.from_params(tp, tcfg, device="cpu", **ekw), tcfg, tp)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_engine_step_by_step_equals_jax(temperature, kind):
    """Five prompts of three buckets' lengths through two rows, the same
    seed: after every ``step()`` each request's ids, status and slot
    equal the JAX engine's (prefill tail on threefry, decode tail on the
    hashed stream, top_k 5 when sampling)."""
    jeng, eng, _, _ = _engines(kind=kind)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 64, n).astype(np.int32)
               for n in (5, 9, 3, 16, 12)]
    reqs = []
    for e in (jeng, eng):
        reqs.append([e.submit(p, max_new=5 + i, temperature=temperature,
                              top_k=5) for i, p in enumerate(prompts)])
    for _ in range(40):
        if jeng.idle and eng.idle:
            break
        done = [sorted(r.rid for r in e.step()) for e in (jeng, eng)]
        assert done[0] == done[1]
        for a, b in zip(*reqs):
            assert (a.tokens, a.status, a.slot) == (b.tokens, b.status,
                                                     b.slot)
    assert eng.idle and all(r.finish_reason == "max_tokens" for r in reqs[1])


def test_engine_matches_generate():
    """Greedy engine output equals ``transformer.generate`` per request,
    with mixed prompt lengths sharing the arena."""
    _, eng, tcfg, tp = _engines()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 64, n).astype(np.int32) for n in (5, 9, 3)]
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    assert len(eng.run_until_idle()) == 3
    for r, p in zip(reqs, prompts):
        want = tt.generate(tp, torch.from_numpy(p[None]), tcfg, max_new=6)
        np.testing.assert_array_equal(r.output, want[0].numpy())
        assert r.finish_reason == "max_tokens"


def test_mid_flight_admission_does_not_perturb():
    _, solo, tcfg, tp = _engines()
    rng = np.random.RandomState(9)
    pa, pb = (rng.randint(0, 64, n).astype(np.int32) for n in (5, 9))
    ra_solo = solo.submit(pa, max_new=8)
    solo.run_until_idle()
    _, eng, _, _ = _engines()
    ra = eng.submit(pa, max_new=8)
    for _ in range(3):
        eng.step()
    assert len(ra.tokens) == 4
    rb = eng.submit(pb, max_new=6)
    eng.run_until_idle()
    np.testing.assert_array_equal(ra.output, ra_solo.output)
    want = tt.generate(tp, torch.from_numpy(pb[None]), tcfg, max_new=6)
    np.testing.assert_array_equal(rb.output, want[0].numpy())


def test_eos_recycles_slot_for_queued_request():
    """EOS frees the one row; the queued request fills it and decodes as
    ``generate`` does. The first request samples (temperature 1): these
    small random models' greedy streams repeat one token, which leaves
    no token to end on mid-stream. Its engine seeds are drawn in the
    same order in both runs (the queued request waits), so its stream
    replays until the eos."""
    _, probe, tcfg, tp = _engines(batch=1)
    rng = np.random.RandomState(10)
    pa, pc = (rng.randint(0, 64, n).astype(np.int32) for n in (5, 7))
    ra = probe.submit(pa, max_new=8, temperature=1.0)
    probe.run_until_idle()
    idx = next(i for i in range(1, len(ra.tokens))
               if ra.tokens[i] not in ra.tokens[:i])
    eos = ra.tokens[idx]
    _, eng, _, _ = _engines(batch=1)
    ra2 = eng.submit(pa, max_new=8, temperature=1.0, eos_id=eos)
    rc = eng.submit(pc, max_new=4)
    assert eng.queue_depth == 2 and eng.free_slots == 1
    eng.step()
    assert rc.status == "queued"
    eng.run_until_idle()
    assert ra2.finish_reason == "eos" and ra2.tokens == ra.tokens[:idx + 1]
    assert rc.slot == 0 and rc.finish_reason == "max_tokens"
    want = tt.generate(tp, torch.from_numpy(pc[None]), tcfg, max_new=4)
    np.testing.assert_array_equal(rc.output, want[0].numpy())


def test_one_program_per_bucket_plus_decode():
    jeng, eng, _, _ = _engines(buckets=(8, 16, 32))
    rng = np.random.RandomState(11)
    for n in (3, 5, 12, 7, 15, 2):              # buckets 8 and 16 only
        p = rng.randint(0, 64, n).astype(np.int32)
        for e in (jeng, eng):
            e.submit(p, max_new=4)
    for e in (jeng, eng):
        e.run_until_idle()
    assert eng.compile_counts() == jeng.compile_counts() == \
        {"prefill": 2, "decode": 1}


def test_submit_guards_count_rejections():
    """The JAX engine's guards, in its order, each counted under its
    reason in both engines."""
    jeng, eng, _, _ = _engines(cache_len=16, buckets=(8,))
    rng = np.random.RandomState(12)
    cases = [(rng.randint(0, 64, 8), 16, "exceed cache_len",
              "exceeds_cache"),
             (rng.randint(0, 64, 12), 2, "largest prefill bucket",
              "prompt_too_long"),
             (rng.randint(0, 64, 12), 9, "largest prefill bucket",
              "prompt_too_long"),
             (rng.randint(0, 64, 4), 0, "max_new", "bad_max_new"),
             (np.zeros(0, np.int32), 2, "empty prompt", "empty_prompt")]
    for prompt, max_new, match, _ in cases:
        for e in (jeng, eng):
            with pytest.raises(ValueError, match=match):
                e.submit(prompt, max_new=max_new)
    for reason in {c[3] for c in cases}:
        want = jeng.metrics.get("engine_requests_rejected_total").value(
            reason=reason)
        assert eng.metrics.get("engine_requests_rejected_total").value(
            reason=reason) == want > 0
    assert eng.queue_depth == 0 and len(eng.request_log) == len(cases)


def test_unseeded_engines_differ():
    rng = np.random.RandomState(13)
    prompt = rng.randint(0, 64, 5).astype(np.int32)
    outs = []
    for _ in range(2):
        _, eng, _, _ = _engines(seed=None)
        r = eng.submit(prompt, max_new=12, temperature=100.0)
        eng.run_until_idle()
        outs.append(list(r.tokens))
    assert outs[0] != outs[1]


def test_health_and_metric_names_equal_jax():
    """After the same three requests: the metric families and their
    counts equal the JAX engine's, and ``health()`` carries the JAX
    document's keys with the same progress numbers (``pallas`` aside:
    the port has no kernel knob; nor ``decode_mfu`` on the CPU, for
    which the port declares no peak and the JAX package a nominal
    one)."""
    jeng, eng, _, _ = _engines()
    rng = np.random.RandomState(14)
    for n in (5, 9, 3):
        p = rng.randint(0, 64, n).astype(np.int32)
        for e in (jeng, eng):
            e.submit(p, max_new=4)
    for e in (jeng, eng):
        e.run_until_idle()

    def names(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}

    assert names(eng.metrics_text()) == names(jeng.metrics_text())
    for name in ("engine_tokens_total", "engine_decode_steps_total",
                 "engine_prefill_calls_total"):
        assert eng.metrics.get(name).value() == \
            jeng.metrics.get(name).value()
    jh, th = jeng.health(), eng.health()
    assert set(jh) - {"pallas", "decode_mfu"} <= set(th)
    for key in ("requests", "completed", "tokens", "decode_steps",
                "slots_total", "cache_len", "prefill_buckets"):
        assert th[key] == jh[key], key
