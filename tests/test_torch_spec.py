"""The port's speculative decoding against ``paddle_tpu``'s, on the CPU.

The models are ``tests/test_spec_decode.py``'s: a 2-layer target
(vocab 40, d_model 16, 2 heads, one kv head, rope; and a learned-
position MHA variant), fp32, a 1-layer draft from seed 7, blocks of 8.
Weights cross through numpy (``params_from_numpy``). The JAX side runs
its Pallas kernels in interpret mode, so its verify tail is
``fused_spec_verify`` on the hashed stream the port's wrappers draw.

What each test takes as its reference:

- the spec tails exactly: ``spec_accept``, ``spec_verify_tokens`` (the
  threefry stream) and ``fused_spec_verify`` (the plain path against the
  Pallas kernel in interpret mode), with per-slot controls that tell an
  element-wise repeat over the window from a tiled one;
- ``verify_step_paged`` against JAX's ``verify_step_paged`` on the same
  inputs: logits and fp32 pools within 1e-4 (the CPU model-vs-JAX
  tolerance: fp32 sums in another order through two layers and the
  vocab head); quantized pools' codes within 1 of JAX's and equal on at
  least 99.9 % of elements, scales within 1e-6 relative (the port's
  quantized step-parity rule, ``test_torch_quant.py``);
- ``verify_step_paged`` against the port's own W sequential
  ``decode_step_paged`` calls within 1e-5 and equal greedy ids. Not
  bitwise: the window's GEMMs run at another row count than the decode
  step's, and whether that changes the last bit depends on the host's
  library (the JAX package's bitwise tests of this fail on some hosts);
- the engine step by step against the JAX ``SpecDecodeEngine``
  (statuses, token counts, proposed/accepted counters; ids and finish
  reasons), greedy and sampled; greedy spec ids against both target-only
  engines; preemption against the port's own unpreempted spec run and
  the JAX target-only engine, with the precondition asserted on both
  engines.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.observe.compile_tracker import CompileTracker
from paddle_tpu.ops.pallas import decode as jdecode
from paddle_tpu.serving import PagedDecodeEngine as JaxPaged
from paddle_tpu.serving import SpecDecodeEngine as JaxSpec
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import costs
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops import q8 as tq8
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.serving import (PagedDecodeEngine, SpecDecodeEngine,
                                      sampling)

torch.set_num_threads(1)

KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
KW_ABS = dict(vocab=40, d_model=16, n_heads=2, n_layers=2, d_ff=32,
              max_len=64, use_rope=False)
BS = 8
K = 3                               # test_spec_decode.py's _mk_spec
ENGINE = dict(batch=3, cache_len=32, block_size=BS, chunk_tokens=8,
              num_blocks=12, seed=0)
POSITIONS = pytest.mark.parametrize("rope", [True, False],
                                    ids=["rope", "learned-pos"])
SAMPLING = pytest.mark.parametrize("temperature", [0.0, 0.8],
                                   ids=["greedy", "sampled"])


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _model(rope: bool = True, same_draft: bool = False):
    """(JAX config, params, draft config, draft params, port config,
    params, draft config, draft params, jitted JAX programs): the
    jitted programs are shared by every JAX engine of a model pair, so
    each compiles once per shape."""
    kw = KW if rope else KW_ABS
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    if same_draft:
        jdcfg, jdp = jcfg, jp
    else:
        jdcfg = jt.TransformerConfig(dtype=jnp.float32,
                                     **dict(kw, n_layers=1))
        jdp = jt.init_params(jax.random.PRNGKey(7), jdcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    tdcfg = tt.TransformerConfig(dtype=torch.float32,
                                 **dict(kw, n_layers=jdcfg.n_layers))

    def port(tree, cfg):
        return tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    cfg, device="cpu")

    pf, df = jsampling.paged_step_fns(jcfg, BS, pallas="interpret")
    spec = jsampling.paged_spec_fns(jcfg, jdcfg, BS, K, pallas="interpret")
    fns = {"prefill": jax.jit(pf), "decode": jax.jit(df),
           **{k: jax.jit(f) for k, f in spec.items()}}
    return (jcfg, jp, jdcfg, jdp, tcfg, port(jp, tcfg), tdcfg,
            port(jdp, tdcfg), fns)


def _jax_spec(rope=True, same_draft=False, **kw):
    jcfg, jp, jdcfg, jdp, *_, fns = _model(rope, same_draft)
    args = dict(ENGINE, **kw)
    nb = args["num_blocks"]
    return JaxSpec(fns["prefill"], fns["decode"], jp,
                   jt.init_block_pool(jcfg, nb, BS), draft_params=jdp,
                   draft_cache=jt.init_block_pool(jdcfg, nb, BS),
                   draft_prefill=fns["draft_prefill"],
                   propose=fns["propose"], verify=fns["verify"],
                   draft_verify=fns["draft_verify"], spec_k=K,
                   tracker=CompileTracker(), decode_flops=None, **args)


def _jax_paged(rope=True, **kw):
    jcfg, jp, *_, fns = _model(rope)
    args = dict(ENGINE, **kw)
    return JaxPaged(fns["prefill"], fns["decode"], jp,
                    jt.init_block_pool(jcfg, args["num_blocks"], BS),
                    tracker=CompileTracker(), decode_flops=None, **args)


def _port_spec(rope=True, same_draft=False, **kw):
    *_, tcfg, tp, tdcfg, tdp, _ = _model(rope, same_draft)
    return SpecDecodeEngine.from_params(tp, tcfg, tdp, tdcfg, spec_k=K,
                                        device="cpu", **dict(ENGINE, **kw))


def _port_paged(rope=True, **kw):
    *_, tcfg, tp, _, _, _ = _model(rope)
    return PagedDecodeEngine.from_params(tp, tcfg, device="cpu",
                                         **dict(ENGINE, **kw))


def _prompts(seed, *lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 40, n).astype(np.int32) for n in lens]


def _spec_counts(eng):
    m = eng.metrics
    return tuple(int(m.get(n).value()) for n in (
        "engine_spec_rounds_total", "engine_spec_proposed_tokens_total",
        "engine_spec_accepted_tokens_total"))


def _drain(eng, reqs, log, max_steps=300):
    """Step to idle, logging every request's status and token count and
    the spec counters after each step, then ids and finish reasons."""
    for _ in range(max_steps):
        if eng.idle:
            break
        eng.step()
        log.append(([(r.status, len(r.tokens)) for r in reqs],
                    _spec_counts(eng), eng.pool.in_use))
    assert eng.idle
    log.append([(list(map(int, r.tokens)), r.finish_reason) for r in reqs])


def _both(scenario, **kw):
    """Run ``scenario(eng, log)`` on the JAX and the port spec engine;
    their logs must be equal. Returns the port engine and its log."""
    logs, engs = [], []
    for make in (_jax_spec, _port_spec):
        eng = make(**kw)
        log = []
        scenario(eng, log)
        resumes = eng.metrics.get("engine_resumes_total")
        log.append({m: int(resumes.value(mode=m))
                    for m in ("remap", "replay")})
        log.append((eng.acceptance_rate(), eng.pool.idle))
        logs.append(log)
        engs.append(eng)
    assert logs[0] == logs[1]
    return engs[1], logs[1]


# ---------------------------------------------------------------------------
# the spec tails
# ---------------------------------------------------------------------------


class TestSpecTails:
    @pytest.mark.parametrize("W", [1, 2, 4])
    def test_spec_accept_matches_jax(self, W):
        """Over 50 seeds: sampled ids from a vocab of 4 (so drafts match
        often), drafts, and valid counts 0..W — n equal to JAX's."""
        for seed in range(50):
            rng = np.random.RandomState(seed)
            B = 6
            X = rng.randint(0, 4, (B, W)).astype(np.int32)
            D = rng.randint(0, 4, (B, W - 1)).astype(np.int32)
            valid = rng.randint(0, W + 1, B).astype(np.int32)
            want = np.asarray(jsampling.spec_accept(
                jnp.asarray(X), jnp.asarray(D), jnp.asarray(valid)))
            got = sampling.spec_accept(_t(X), _t(D), _t(valid))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=seed)

    def test_spec_accept_reference_cases(self):
        """``test_spec_decode.py``'s worked cases: a full run emits k+1,
        a break at j emits j+1, no match emits 1, valid caps the run; a
        one-row window emits min(1, valid)."""
        X = _t([[5, 6, 7, 8], [5, 6, 7, 8], [1, 2, 3, 4], [5, 6, 7, 8]])
        D = _t([[5, 6, 7], [5, 9, 7], [9, 9, 9], [5, 6, 7]])
        n = sampling.spec_accept(X, D, _t(np.asarray([4, 4, 4, 2])))
        assert n.tolist() == [4, 2, 1, 2]
        empty = torch.zeros((2, 0), dtype=torch.int32)
        n1 = sampling.spec_accept(_t([[3], [3]]), empty,
                                  _t(np.asarray([1, 0], np.int32)))
        assert n1.tolist() == [1, 0]

    def test_spec_verify_tokens_matches_jax(self):
        """The threefry window tail: every slot its own temperature and
        top_k, sampled ids and n equal to JAX's ``spec_verify_tokens``
        under ``PRNGKey(seed)`` over several seeds."""
        rng = np.random.RandomState(3)
        B, W, V = 3, 4, 40
        temp = np.asarray([0.0, 0.8, 1.3], np.float32)
        topk = np.asarray([0, 5, 12], np.int32)
        valid = np.asarray([4, 3, 2], np.int32)
        for seed in range(6):
            logits = (2.0 * rng.randn(B, W, V)).astype(np.float32)
            draft = logits.argmax(-1)[:, :W - 1].astype(np.int32)
            draft[seed % B, seed % (W - 1)] += 1
            jX, jn = jsampling.spec_verify_tokens(
                jnp.asarray(logits), jnp.asarray(draft),
                jax.random.PRNGKey(seed), jnp.asarray(temp),
                jnp.asarray(topk), jnp.asarray(valid))
            X, n = sampling.spec_verify_tokens(
                _t(logits), _t(draft), prng.prng_key(seed), _t(temp),
                _t(topk), _t(valid))
            np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
            np.testing.assert_array_equal(n.numpy(), np.asarray(jn))

    def test_fused_spec_verify_matches_pallas_interpret(self):
        """The plain path of ``fused_spec_verify`` against the Pallas
        ``fused_spec_verify`` in interpret mode: ids and n equal over
        several seeds, every slot with its own temperature and top_k;
        and the same controls repeated tiled instead of element-wise
        give other ids for some seed, so the test tells the two apart."""
        rng = np.random.RandomState(5)
        B, W, V = 3, 4, 40
        temp = np.asarray([0.0, 0.8, 1.3], np.float32)
        topk = np.asarray([0, 3, 20], np.int32)
        valid = np.asarray([4, 3, 4], np.int32)
        tiled_differs = False
        for seed in range(8):
            logits = (2.0 * rng.randn(B, W, V)).astype(np.float32)
            draft = logits.argmax(-1)[:, :W - 1].astype(np.int32)
            draft[2, seed % (W - 1)] = (draft[2, seed % (W - 1)] + 1) % V
            jX, jn = jdecode.fused_spec_verify(
                jnp.asarray(logits), jnp.asarray(draft), jnp.int32(seed),
                jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(valid),
                interpret=True)
            X, n = kdecode.fused_spec_verify(_t(logits), _t(draft), seed,
                                             _t(temp), _t(topk), _t(valid))
            np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
            np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
            tiled = kdecode.fused_sample(
                _t(logits).reshape(B * W, V), seed, _t(temp).repeat(W),
                _t(topk).repeat(W)).reshape(B, W)
            tiled_differs |= not torch.equal(tiled, X)
        assert tiled_differs
        assert n.tolist()[0] == 4      # greedy slot, matching drafts

    def test_window_rows_repeat_element_wise(self):
        x = _t(np.asarray([1, 2, 3], np.int32))
        assert sampling.window_rows(x, 2).tolist() == [1, 1, 2, 2, 3, 3]
        assert torch.equal(sampling.window_rows(x, 3),
                           x.repeat_interleave(3))


# ---------------------------------------------------------------------------
# verify_step_paged
# ---------------------------------------------------------------------------


def _random_pools(rng, cfg, nb, kvd):
    """The same random pool for both packages: fp32 values, bf16 values
    (``kvd="bf16"``: a model-dtype pool stored in bf16 beside the fp32
    model, its values rounded once, in torch), or int8 codes (int4 nibble
    pairs) with fp32 scales, drawn with numpy."""
    L, Hkv, Dh, M = cfg.n_layers, cfg.kv_heads, cfg.head_dim, nb * BS
    if kvd == "bf16":
        t = {n: torch.from_numpy(0.5 * rng.randn(L, Hkv, M, Dh).astype(
            np.float32)).to(torch.bfloat16) for n in ("k", "v")}
        return ({n: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                 for n, v in t.items()}, t)
    if kvd is None:
        arrs = {n: (0.5 * rng.randn(L, Hkv, M, Dh)).astype(np.float32)
                for n in ("k", "v")}
    else:
        width = Dh // 2 if kvd == "int4" else Dh
        arrs = {n: rng.randint(-100, 100, (L, Hkv, M, width)).astype(np.int8)
                for n in ("k", "v")}
        arrs.update({n: (0.001 + 0.02 * rng.rand(L, Hkv, M))
                     .astype(np.float32) for n in ("k_scale", "v_scale")})
    return ({n: jnp.asarray(a) for n, a in arrs.items()},
            {n: _t(a) for n, a in arrs.items()})


def _pools_close(tpool, jpool, kvd):
    """fp32 pools within 1e-4; bf16 pools within one bf16 ulp (the fp32
    rows written agree within 1e-4, and one rounding to bf16 may land
    them on two sides of a rounding boundary); quantized codes within 1
    of JAX's and equal on >= 99.9 % of elements (int4 nibble by nibble),
    scales within 1e-6 relative."""
    for n in ("k", "v"):
        if kvd == "bf16":
            np.testing.assert_allclose(
                tpool[n].float().numpy(),
                np.asarray(jpool[n].astype(jnp.float32)), rtol=2 ** -7,
                atol=0)
            continue
        a, b = tpool[n], _t(jpool[n])
        if kvd is None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4)
            continue
        if kvd == "int4":
            a, b = tq8.unpack_int4(a), tq8.unpack_int4(b)
        d = (a.int() - b.int()).abs()
        assert d.max() <= 1
        assert (d == 0).float().mean() >= 0.999
        np.testing.assert_allclose(tpool[n + "_scale"].numpy(),
                                   np.asarray(jpool[n + "_scale"]),
                                   rtol=1e-6, atol=0)


def _verify_inputs(rng, B=3, W=4, P=4):
    """Slots on disjoint pages (P each, block 0 left out), positions with
    room for part of the window, per-slot valid rows, one inactive slot."""
    pages = (1 + np.arange(B * P, dtype=np.int32)).reshape(B, P)
    pos = np.asarray([6, 13, 20][:B], np.int32)
    valid = np.asarray([4, 2, 3][:B], np.int32)
    active = np.asarray([True, True, False][:B])
    tokens = rng.randint(0, 40, (B, W)).astype(np.int32)
    return tokens, pos, valid, active, pages


class TestVerifyStepPaged:
    @POSITIONS
    @pytest.mark.parametrize("kvd", [None, "bf16", "int8", "int4"])
    def test_matches_jax_verify(self, rope, kvd):
        """Logits within 1e-4 of JAX's ``verify_step_paged`` on the same
        inputs, and the written pool by the step-parity rule, for rope
        and learned positions over fp32, bf16, int8 and int4 pools."""
        jcfg, jp, _, _, tcfg, tp, _, _, _ = _model(rope)
        rng = np.random.RandomState(11)
        jpool, tpool = _random_pools(rng, tcfg, 13, kvd)
        tokens, pos, valid, active, pages = _verify_inputs(rng)
        jl, jpool2 = jt.verify_step_paged(
            jp, jpool, jnp.asarray(tokens), jnp.asarray(pos),
            jnp.asarray(valid), jnp.asarray(active), jnp.asarray(pages),
            jcfg, block_size=BS)
        tl, tpool2 = tt.verify_step_paged(
            tp, tpool, _t(tokens), _t(pos), _t(valid), _t(active),
            _t(pages), tcfg, block_size=BS)
        assert tl.shape == (3, 4, 40)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        _pools_close(tpool2, jpool2, kvd)

    @POSITIONS
    @pytest.mark.parametrize("kvd", [None, "int8", "int4"])
    def test_matches_own_decode_steps(self, rope, kvd):
        """One window of W = 4 rows against 4 sequential
        ``decode_step_paged`` calls of the port from the same pool state
        (the window's tokens are the steps' greedy ids): logits within
        1e-5 and equal greedy ids for the active slots, and the pools
        within 1e-5 (codes within 1). Not bitwise: the window's GEMMs run
        at 3 x 4 rows, the steps' at 3, and whether that moves the last
        bit depends on the host's BLAS."""
        *_, tcfg, tp, _, _, _ = _model(rope)
        rng = np.random.RandomState(12)
        _, pool_s = _random_pools(rng, tcfg, 13, kvd)
        pool_v = {n: t.clone() for n, t in pool_s.items()}
        _, pos, _, active, pages = _verify_inputs(rng)
        tok = _t(rng.randint(0, 40, 3).astype(np.int32))
        pos, active, pages = _t(pos), _t(active), _t(pages)
        seq, window = [], [tok]
        for j in range(4):
            lg, _ = tt.decode_step_paged(tp, pool_s, tok, pos + j, active,
                                         pages, tcfg, block_size=BS)
            seq.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
            if j < 3:
                window.append(tok)
        vl, _ = tt.verify_step_paged(
            tp, pool_v, torch.stack(window, 1), pos,
            torch.full((3,), 4, dtype=torch.int32), active, pages, tcfg,
            block_size=BS)
        seq = torch.stack(seq, 1)
        assert (vl[:2] - seq[:2]).abs().max().item() <= 1e-5
        assert torch.equal(vl[:2].argmax(-1), seq[:2].argmax(-1))
        for n in pool_s:
            a, b = pool_v[n], pool_s[n]
            if kvd == "int4" and n in ("k", "v"):
                a, b = tq8.unpack_int4(a), tq8.unpack_int4(b)
            tol = 1e-5 if a.is_floating_point() else 1
            assert (a.double() - b.double()).abs().max().item() <= tol, n

    @pytest.mark.parametrize("kvd", [None, "int8", "int4"])
    def test_dead_rows_and_inactive_slots_write_nothing(self, kvd):
        """Byte-exact on the port's pool (``test_spec_decode.py``'s
        isolation case): slot 0 (valid 2) changes exactly its rows at
        pos and pos + 1, the inactive slot 1 (valid 4) none of its rows,
        and nothing else moves — values and scales."""
        *_, tcfg, tp, _, _, _ = _model(True)
        rng = np.random.RandomState(13)
        _, pool = _random_pools(rng, tcfg, 9, kvd)
        before = {n: t.clone() for n, t in pool.items()}
        pages = _t((1 + np.arange(8, dtype=np.int32)).reshape(2, 4))
        pos = _t(np.asarray([6, 9], np.int32))
        window = _t(rng.randint(0, 40, (2, 4)).astype(np.int32))
        tt.verify_step_paged(tp, pool, window, pos,
                             _t(np.asarray([2, 4], np.int32)),
                             _t(np.asarray([True, False])), pages, tcfg,
                             block_size=BS)
        want = {1 * BS + 6, 1 * BS + 7}          # slot 0's block 1, rows 6-7
        for n in pool:
            bits = (torch.int32 if pool[n].dtype == torch.float32
                    else pool[n].dtype)
            diff = pool[n].view(bits) != before[n].view(bits)
            while diff.dim() > 3:
                diff = diff.any(-1)
            rows = set(diff.any(0).any(0).nonzero()[:, 0].tolist())
            assert rows == want, (n, rows)

    def test_propose_masks_writes_beyond_valid(self):
        """``test_spec_decode.py``'s case on the port: near the end of a
        request (valid 1 of a k = 3 proposal), propose's later steps
        would write through the zeroed page-table tail into block 0 —
        another slot's rows. The mask keeps block 0 byte for byte, while
        the one valid step's write lands in block 3."""
        *_, tdcfg, tdp, _ = _model(True)
        fns = sampling.paged_spec_fns(_model(True)[4], tdcfg, BS, 3)
        pool = tt.init_block_pool(tdcfg, 6, BS, device="cpu")
        for t in pool.values():
            t[:, :, :BS] = 7.0
        props, out = fns["propose"].raw(
            tdp, pool, _t(np.asarray([1], np.int32)),
            _t(np.asarray([BS - 1], np.int32)), _t(np.asarray([True])),
            _t(np.asarray([1], np.int32)),
            _t(np.asarray([[3, 0, 0]], np.int32)))
        assert out is pool and props.shape == (1, 3)
        for leaf in ("k", "v"):
            assert torch.equal(out[leaf][:, :, :BS],
                               torch.full_like(out[leaf][:, :, :BS], 7.0))
        assert out["k"][:, :, 3 * BS + BS - 1].abs().sum() > 0

    def test_propose_matches_jax(self):
        """The propose program against JAX's (greedy draft decode steps,
        writes masked to valid rows): proposals equal, draft pools within
        1e-4."""
        jcfg, _, jdcfg, jdp, tcfg, _, tdcfg, tdp, fns = _model(True)
        rng = np.random.RandomState(14)
        jpool, tpool = _random_pools(rng, tdcfg, 13, None)
        _, pos, valid, active, pages = _verify_inputs(rng)
        last = rng.randint(0, 40, 3).astype(np.int32)
        jprops, jpool2 = fns["propose"](
            jdp, jpool, jnp.asarray(last), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(valid), jnp.asarray(pages))
        prog = sampling.paged_spec_fns(tcfg, tdcfg, BS, K)["propose"]
        tprops, tpool2 = prog(tdp, tpool, last, pos, active, valid,
                              _t(pages))
        act = np.flatnonzero(active)
        np.testing.assert_array_equal(tprops.numpy()[act],
                                      np.asarray(jprops)[act])
        _pools_close(tpool2, jpool2, None)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class TestSpecEngine:
    @POSITIONS
    @SAMPLING
    def test_steps_match_jax(self, rope, temperature):
        """``test_spec_decode.py``'s greedy trace (an unrelated draft:
        low acceptance) through both spec engines, greedy and at
        temperature 0.8 / top_k 20: equal after every step, equal ids."""
        prompts = _prompts(1, 5, 9, 13, 3, 17)

        def scenario(eng, log):
            reqs = [eng.submit(p, max_new=12, temperature=temperature,
                               top_k=20 if temperature else 0)
                    for p in prompts]
            _drain(eng, reqs, log)
        eng, _ = _both(scenario, rope=rope)
        acc = eng.acceptance_rate()
        assert acc is not None and 0.0 <= acc < 1.0

    @SAMPLING
    def test_identical_draft_matches_jax(self, temperature, rng):
        """Draft == target, on ``test_spec_decode.py``'s prompts: both
        engines step alike; greedy acceptance is exactly 1.0 (every
        proposal is the target's own argmax; on other prompts a near-tie
        that the draft's M = B GEMM and the verify's M = B * W GEMM round
        apart can reject one, in both packages alike)."""
        prompts = [rng.randint(0, 40, n).astype(np.int32) for n in (5, 9)]

        def scenario(eng, log):
            reqs = [eng.submit(p, max_new=10, temperature=temperature,
                               top_k=20 if temperature else 0)
                    for p in prompts]
            _drain(eng, reqs, log)
        eng, _ = _both(scenario, same_draft=True)
        if temperature == 0.0:
            assert eng.acceptance_rate() == 1.0

    def test_eos_mid_window(self):
        """An accepted window holding eos finishes the request at eos
        (later window tokens dropped), as the target-only engine does."""
        prompt = _prompts(3, 5)[0]
        ref = _port_paged(batch=1)
        r0 = ref.submit(prompt, max_new=12)
        ref.run_until_idle()
        eos = int(r0.tokens[4])
        ref2 = _port_paged(batch=1)
        ra = ref2.submit(prompt, max_new=12, eos_id=eos)
        ref2.run_until_idle()

        def scenario(eng, log):
            rb = eng.submit(prompt, max_new=12, eos_id=eos)
            _drain(eng, [rb], log)
            assert list(rb.tokens) == list(ra.tokens)
            assert rb.finish_reason == ra.finish_reason == "eos"
        _both(scenario, same_draft=True, batch=1)

    def test_greedy_equals_target_only(self, rng):
        """``test_spec_decode.py``'s greedy trace: the port's spec engine,
        the port's target-only engine and the JAX target-only engine give
        equal ids."""
        prompts = [rng.randint(0, 40, n).astype(np.int32)
                   for n in (5, 9, 13, 3, 17)]

        def run(eng):
            reqs = [eng.submit(p, max_new=12) for p in prompts]
            eng.run_until_idle()
            return [list(map(int, r.tokens)) for r in reqs]
        spec = _port_spec()
        got = run(spec)
        assert got == run(_port_paged()) == run(_jax_paged())
        assert spec.pool.idle

    @pytest.mark.parametrize("mode", ["remap", "replay"])
    @SAMPLING
    def test_preempt_and_resume(self, mode, temperature):
        """A spec victim preempted by a latency-tier arrival resumes by
        remap (its blocks survive) or replay (the arrival's worst case is
        the whole pool; the forced history replays through verify
        windows and ``draft_verify``). The victim is running when the
        arrival comes, on both engines; each engine's resume count for
        the mode is 1; both engines agree step by step. Greedy: the
        victim's ids equal the port's unpreempted spec run and the JAX
        target-only engine's."""
        prompt, other = _prompts(4, 8, 16)
        adv_len, adv_new = (8, 4) if mode == "remap" else (16, 16)
        ctl = dict(temperature=temperature, top_k=20 if temperature else 0)
        victims = []

        def scenario(eng, log):
            v = eng.submit(prompt, max_new=16, tier="batch", **ctl)
            victims.append(v)
            while len(v.tokens) < 2:
                eng.step()
                log.append((v.status, len(v.tokens), _spec_counts(eng)))
            assert v.status == "running"
            a = eng.submit(other[:adv_len], max_new=adv_new, tier="latency")
            eng.step()
            assert v.status == "preempted"
            _drain(eng, [v, a], log)
            log.append(eng.compile_counts()["draft_verify"])
        kw = dict(batch=2, num_blocks=4)
        eng, _ = _both(scenario, **kw)
        resumes = eng.metrics.get("engine_resumes_total")
        assert int(resumes.value(mode=mode)) == 1
        assert victims[1].preemptions == 1 and eng.pool.idle
        if mode == "replay":
            assert eng.compile_counts()["draft_verify"] == 1
        if temperature:
            return
        solo = _port_spec(**kw)
        r = solo.submit(prompt, max_new=16)
        solo.run_until_idle()
        ref = _jax_paged(**kw)
        rj = ref.submit(prompt, max_new=16)
        ref.run_until_idle()
        assert list(victims[1].tokens) == list(r.tokens) == \
            list(map(int, rj.tokens))

    def test_compile_discipline(self):
        """``test_spec_decode.py``'s program count: the target's prefill
        programs are the target-only engine's, the draft's the same
        number, one propose and one verify, no decode; equal to the JAX
        spec engine's counts."""
        prompts = _prompts(5, 5, 13)
        counts = []
        for eng in (_port_paged(), _port_spec(), _jax_spec()):
            for p in prompts:
                eng.submit(p, max_new=8)
            eng.run_until_idle()
            counts.append(eng.compile_counts())
        ref, spec, jspec = counts
        assert spec["prefill"] == ref["prefill"]
        assert spec["draft_prefill"] == ref["prefill"]
        assert spec["propose"] == 1 and spec["verify"] == 1
        assert spec["decode"] == 0 and ref["decode"] == 1
        assert spec["draft_verify"] == 0
        assert spec == jspec

    def test_health_spec_section_matches_jax(self):
        def scenario(eng, log):
            r = eng.submit(_prompts(6, 5)[0], max_new=6)
            _drain(eng, [r], log)
            log.append(eng.health()["spec"])
        _, log = _both(scenario)
        doc = log[-3]
        assert doc["k"] == K and doc["rounds"] >= 1
        assert doc["acceptance_rate"] is not None

    def test_refusals(self):
        """``tiers=`` and ``import_prefix`` are refused (the draft rows
        cannot ride the single-pool payload), as are a draft of another
        vocab, a cache longer than the draft's positions and spec_k 0;
        ``export_prefix`` works."""
        *_, tcfg, tp, tdcfg, tdp, _ = _model(True)
        with pytest.raises(ValueError, match="tiered"):
            SpecDecodeEngine.from_params(tp, tcfg, tdp, tdcfg, spec_k=K,
                                         device="cpu",
                                         tiers={"dram_bytes": 1 << 20},
                                         **ENGINE)
        bad = tt.TransformerConfig(dtype=torch.float32,
                                   **dict(KW, vocab=39, n_layers=1))
        with pytest.raises(ValueError, match="vocab"):
            SpecDecodeEngine.from_params(
                tp, tcfg, tt.init_params(bad, torch.Generator().manual_seed(1),
                                         "cpu"), bad, spec_k=2,
                device="cpu", **ENGINE)
        short = tt.TransformerConfig(dtype=torch.float32,
                                     **dict(KW, max_len=16, n_layers=1))
        with pytest.raises(ValueError, match="max_len"):
            SpecDecodeEngine.from_params(tp, tcfg, tdp, short, spec_k=K,
                                         device="cpu", **ENGINE)
        with pytest.raises(ValueError, match="spec_k"):
            SpecDecodeEngine.from_params(tp, tcfg, tdp, tdcfg, spec_k=0,
                                         device="cpu", **ENGINE)
        eng = _port_spec()
        prompt = _prompts(7, 20)[0]
        eng.submit(prompt, max_new=1)
        eng.run_until_idle()
        payload = eng.export_prefix(prompt)
        assert isinstance(payload, bytes)
        with pytest.raises(ValueError, match="import_prefix"):
            eng.import_prefix(payload)

    def test_programs_share_the_target_context(self):
        """The four spec programs run under the JAX tracker names in the
        engine's tracker and share the target pair's graph context (one
        capture stream, one memory pool)."""
        eng = _port_spec()
        progs = (eng._draft_prefill_fn, eng._propose_fn, eng._verify_fn,
                 eng._draft_verify_fn)
        assert [p.name for p in progs] == [
            "serving_engine.draft_prefill", "serving_engine.propose",
            "serving_engine.verify", "serving_engine.draft_verify"]
        assert all(p.context is eng._decode_fn.context for p in progs)
        assert all(p.tracker is eng._tracker for p in progs)
        assert eng._tracker.storm_threshold == 2 * 4 * 1 + 8

    def test_verify_flops_count_every_window_row(self):
        *_, tcfg, _, _, _, _ = _model(True)
        assert costs.verify_step_flops(tcfg, [3, 7], 2) == \
            costs.decode_step_flops(tcfg, [3, 4, 7, 8])
