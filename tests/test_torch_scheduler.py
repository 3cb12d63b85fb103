"""The port's multi-tenant scheduler against ``paddle_tpu``'s, on the CPU.

Each case of ``tests/test_multitenant.py``'s ``TestPreemptToBlocks`` and
``TestTenantBudgets`` is driven, operation for operation, through both
engines over the same weights and prompts: after every scheduler step
the requests' statuses, token counts and preemptions, the engine's
``preempted_count`` and the pool's occupancy must agree, and at the end
the emitted ids (greedy, and sampled at temperature 0.8 / top_k 20),
finish reasons and resume modes. The JAX engine runs its Pallas kernels
in interpret mode, so its sampler draws on the streams the port's
kernel wrappers draw on. Each case also keeps the reference test's own
assertions. ``BlockPool.unpublish`` makes the JAX pool's decisions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.observe.compile_tracker import CompileTracker
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import blocks as jblocks
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.serving import blocks as tblocks

torch.set_num_threads(1)

# tests/test_multitenant.py's CFG, and the wider one of its
# double-preemption case
KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
KW_WIDE = dict(vocab=64, d_model=32, n_heads=2, n_kv_heads=1, n_layers=2,
               d_ff=64, max_len=64, use_rope=True)
BS = 8


@functools.lru_cache(maxsize=None)
def _model(wide: bool):
    """(JAX config, JAX params, port config, port params, jitted JAX
    step functions): the jitted functions are shared by every JAX engine
    of a model, so each program compiles once per shape."""
    kw = KW_WIDE if wide else KW
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    pf, df = jsampling.paged_step_fns(jcfg, BS, pallas="interpret")
    return jcfg, jp, tcfg, tp, (jax.jit(pf), jax.jit(df))


def _engines(batch=2, num_blocks=None, cache_len=32, wide=False, **kw):
    """(JAX engine, port engine), configured alike."""
    jcfg, jp, tcfg, tp, (pf, df) = _model(wide)
    nb = num_blocks if num_blocks is not None else batch * cache_len // BS
    common = dict(batch=batch, cache_len=cache_len, block_size=BS,
                  num_blocks=nb, chunk_tokens=8, seed=0, **kw)
    jeng = JaxEngine(pf, df, jp, jt.init_block_pool(jcfg, nb, BS),
                     tracker=CompileTracker(), decode_flops=None, **common)
    teng = PagedDecodeEngine.from_params(tp, tcfg, device="cpu", **common)
    return jeng, teng


def _state(eng, reqs):
    return ([(r.status, len(r.tokens), r.preemptions) for r in reqs],
            eng.preempted_count, eng.pool.in_use, eng.pool.cached_count,
            eng.pool.reserved)


def _resumes(eng):
    m = eng.metrics.get("engine_resumes_total")
    return {mode: int(m.value(mode=mode)) for mode in ("remap", "replay")}


def _both(scenario, **engine_kw):
    """Run ``scenario(eng, log)`` on both engines; their logs must be
    equal. Returns the port engine's log."""
    logs = []
    for eng in _engines(**engine_kw):
        log = []
        scenario(eng, log)
        log.append(("resumes", _resumes(eng)))
        log.append(("preemptions", int(eng.metrics.get(
            "engine_preemptions_total").value())))
        log.append(("idle", eng.pool.idle))
        logs.append(log)
    assert logs[0] == logs[1]
    return logs[1]


def _drain(eng, reqs, log, max_steps=500):
    """Step to idle, logging the state after every step, then each
    request's ids and finish reason."""
    for _ in range(max_steps):
        if eng.idle:
            break
        eng.step()
        log.append(_state(eng, reqs))
    assert eng.idle
    log.append([(list(map(int, r.tokens)), r.finish_reason) for r in reqs])


def _prompts(seed, *lens, vocab=40):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _solo_tokens(prompt, max_new):
    """The same greedy request alone on a fresh port engine."""
    _, teng = _engines(num_blocks=8)
    req = teng.submit(prompt, max_new=max_new)
    teng.run_until_idle()
    return list(map(int, req.tokens))


SAMPLING = pytest.mark.parametrize("temperature", [0.0, 0.8],
                                   ids=["greedy", "sampled"])


class TestPreemptToBlocks:
    def test_latency_arrival_preempts_exactly_one_victim(self):
        pa, pb, pl = _prompts(1, 8, 8, 8)

        def scenario(eng, log):
            va = eng.submit(pa, max_new=16, tier="batch")    # 3 blocks
            vb = eng.submit(pb, max_new=16, tier="batch")    # 3 blocks
            reqs = [va, vb]
            for _ in range(4):
                eng.step()
                log.append(_state(eng, reqs))
            assert va.status == "running" and vb.status == "running"
            lat = eng.submit(pl, max_new=8, tier="latency")  # needs 2
            reqs.append(lat)
            eng.step()
            log.append(_state(eng, reqs))
            assert lat.status in ("prefilling", "running")
            assert len([r for r in (va, vb)
                        if r.status == "preempted"]) == 1
            _drain(eng, reqs, log)
            assert {r.finish_reason for r in reqs} == {"max_tokens"}

        log = _both(scenario, batch=3, num_blocks=6)
        assert ("preemptions", 1) in log and ("idle", True) in log

    @SAMPLING
    def test_preempt_resume_remap_bitwise(self, temperature):
        prompt, pl = _prompts(2, 8, 8)
        ref = _solo_tokens(prompt, 16) if temperature == 0.0 else None

        def scenario(eng, log):
            v = eng.submit(prompt, max_new=16, tier="batch",
                           temperature=temperature, top_k=20)
            for _ in range(6):
                eng.step()
                log.append(_state(eng, [v]))
            assert v.status == "running" and len(v.tokens) >= 3
            lat = eng.submit(pl, max_new=8, tier="latency",
                             temperature=temperature, top_k=20)
            eng.step()
            log.append(_state(eng, [v, lat]))
            assert v.status == "preempted" and eng.preempted_count == 1
            _drain(eng, [v, lat], log)
            assert lat.finish_reason == "max_tokens"
            if temperature == 0.0:
                assert list(v.tokens) == ref

        log = _both(scenario, num_blocks=4)
        assert ("resumes", {"remap": 1, "replay": 0}) in log

    @SAMPLING
    def test_preempt_resume_replay_bitwise_after_eviction(self, temperature):
        prompt, pl = _prompts(3, 8, 16)
        ref = _solo_tokens(prompt, 16) if temperature == 0.0 else None

        def scenario(eng, log):
            v = eng.submit(prompt, max_new=16, tier="batch",
                           temperature=temperature, top_k=20)
            for _ in range(6):
                eng.step()
                log.append(_state(eng, [v]))
            # the latency request's worst case is the whole 4-block pool:
            # its allocations evict every parked victim block
            lat = eng.submit(pl, max_new=16, tier="latency",
                             temperature=temperature, top_k=20)
            eng.step()
            log.append(_state(eng, [v, lat]))
            assert v.status == "preempted"
            _drain(eng, [v, lat], log)
            assert lat.finish_reason == "max_tokens"
            if temperature == 0.0:
                assert list(v.tokens) == ref

        log = _both(scenario, num_blocks=4)
        assert ("resumes", {"remap": 0, "replay": 1}) in log

    def test_preempted_mid_prefill_requeues_and_completes(self):
        prompt, pd, pl = _prompts(4, 24, 8, 8)             # 3 chunks
        ref = _solo_tokens(prompt, 8)

        def scenario(eng, log):
            d = eng.submit(pd, max_new=6, tier="batch")
            eng.step()
            assert d.status == "running"
            v = eng.submit(prompt, max_new=8, tier="batch")   # 4 blocks
            eng.step()                                        # chunk 1
            assert v.status == "prefilling"
            lat = eng.submit(pl, max_new=8, tier="latency")
            eng.step()
            log.append(_state(eng, [d, v, lat]))
            assert v.preemptions == 1 and v.status == "queued"
            _drain(eng, [d, v, lat], log)
            assert lat.finish_reason == "max_tokens"
            assert list(v.tokens) == ref

        _both(scenario, batch=3, num_blocks=6)

    def test_latency_tier_admits_ahead_of_earlier_batch(self):
        (p,) = _prompts(5, 8)

        def scenario(eng, log):
            running = eng.submit(p, max_new=4, tier="batch")
            eng.step()
            b = eng.submit(p, max_new=4, tier="batch")
            lat = eng.submit(p, max_new=4, tier="latency")
            _drain(eng, [running, b, lat], log)
            assert lat.first_token_t < b.first_token_t
            assert running.finish_reason == "max_tokens"

        _both(scenario, batch=1, num_blocks=8)


class TestTenantBudgets:
    def test_budget_exhaustion_queues_not_rejects(self):
        (p,) = _prompts(6, 8)

        def scenario(eng, log):
            r1 = eng.submit(p, max_new=8, tenant="acme")     # charge 16
            r2 = eng.submit(p, max_new=8, tenant="acme")     # over budget
            eng.step()
            log.append(_state(eng, [r1, r2]))
            assert r1.status in ("prefilling", "running")
            assert r2.status == "queued"
            rejected = eng.metrics.get("engine_requests_rejected_total")
            assert all(rejected.value(reason=r) == 0
                       for r in ("bad_tier", "exceeds_pool"))
            _drain(eng, [r1, r2], log)
            assert r2.prefill_t > r1.finish_t   # admitted only after r1

        _both(scenario, batch=4, num_blocks=16, tenant_budgets={"acme": 20})

    def test_budget_blocked_tenant_skipped_not_head_of_line(self):
        (p,) = _prompts(7, 8)

        def scenario(eng, log):
            reqs = [eng.submit(p, max_new=8, tenant=t)
                    for t in ("acme", "acme", "other")]
            eng.step()
            log.append(_state(eng, reqs))
            assert reqs[1].status == "queued"
            assert reqs[2].status in ("prefilling", "running")
            _drain(eng, reqs, log)
            assert all(r.finish_reason == "max_tokens" for r in reqs)

        _both(scenario, batch=4, num_blocks=16, tenant_budgets={"acme": 20})

    def test_own_charge_exceeding_budget_rejected_not_queued(self):
        (p,) = _prompts(8, 8)

        def scenario(eng, log):
            with pytest.raises(ValueError, match="budget"):
                eng.submit(p, max_new=8, tenant="acme")      # charge 16
            with pytest.raises(ValueError, match="tier"):
                eng.submit(p, max_new=8, tier="bulk")
            rejected = eng.metrics.get("engine_requests_rejected_total")
            log.append([int(rejected.value(reason=r))
                        for r in ("exceeds_budget", "bad_tier")])
            assert eng.idle

        log = _both(scenario, num_blocks=8, tenant_budgets={"acme": 10})
        assert log[0] == [1, 1]

    def test_tenant_state_pruned_at_zero(self):
        (p,) = _prompts(9, 8)

        def scenario(eng, log):
            reqs = [eng.submit(p, max_new=4, tenant=f"drive-by-{i}")
                    for i in range(5)]
            reqs.append(eng.submit(p, max_new=4, tenant="acme"))
            _drain(eng, reqs, log)
            assert eng._tenant_used == {}
            txt = eng.metrics_text()
            assert 'tenant="acme"' in txt and "drive-by" not in txt
            log.append(sorted(eng.health().get("tenants", {})))

        log = _both(scenario, num_blocks=8, tenant_budgets={"acme": 64})
        assert ["acme"] in log

    def test_infeasible_latency_does_not_mass_evict(self):
        p, big = _prompts(10, 8, 16)

        def scenario(eng, log):
            b1 = eng.submit(p, max_new=8, tier="batch")
            b2 = eng.submit(p, max_new=8, tier="batch")
            lat1 = eng.submit(big, max_new=16, tier="latency")   # 4 blocks
            reqs = [b1, b2, lat1]
            for _ in range(4):
                eng.step()
                log.append(_state(eng, reqs))
            assert lat1.status in ("prefilling", "running")
            # its 4 blocks can never fit beside lat1's 4 in 6 blocks
            lat2 = eng.submit(big, max_new=16, tier="latency")
            reqs.append(lat2)
            eng.step()
            assert int(eng.metrics.get(
                "engine_preemptions_total").value()) == 0
            _drain(eng, reqs, log)
            assert all(r.finish_reason == "max_tokens" for r in reqs)

        _both(scenario, batch=3, num_blocks=6)

    def test_double_preemption_of_replay_victim_no_reemission(self):
        """A victim resumed by replay and preempted AGAIN mid-replay
        prefill keeps its un-replayed history: no token is emitted
        twice and the output is the solo run's. The reference case
        relies on a greedy sequence that changes with the position,
        which its random model does not give on every host (ROADMAP C);
        the victim here samples at temperature 1.0, whose draws change
        with the position whatever the model."""
        prompt, pd = _prompts(7, 16, 4, vocab=64)          # 2 chunks
        solo = []

        def scenario(eng, log):
            d = eng.submit(pd, max_new=24, tier="batch")   # keeps decode
            eng.step()                                     # live
            v = eng.submit(prompt, max_new=8, tier="batch",
                           temperature=1.0, top_k=0)
            while not (v.status == "running" and len(v.tokens) >= 2):
                eng.step()
            emitted = list(v.tokens)
            eng._preempt(v.slot)                           # preempt #1
            # evict one snapshot block so that resume must replay
            eng.pool.unpublish(eng.pool.lookup(v.snapshot["hashes"][0]))
            while not (v.status == "prefilling"
                       and eng._slot_forced[v.slot]):
                eng.step()
            eng._preempt(v.slot)                           # preempt #2
            assert v.preemptions == 2
            _drain(eng, [d, v], log)
            assert list(v.tokens)[:len(emitted)] == emitted
            assert d.finish_reason == "max_tokens"
            solo.append(list(map(int, v.tokens)))

        log = _both(scenario, batch=3, num_blocks=8, wide=True)
        assert ("resumes", {"remap": 0, "replay": 1}) in log
        assert solo[0] == solo[1] and len(solo[1]) == 8
        assert len(set(solo[1][:3])) >= 2    # a restart would show

    def test_set_tenant_budget_runtime(self):
        (p,) = _prompts(11, 8)

        def scenario(eng, log):
            eng.set_tenant_budget("acme", 16)
            r1 = eng.submit(p, max_new=8, tenant="acme")
            r2 = eng.submit(p, max_new=8, tenant="acme")
            eng.step()
            log.append(_state(eng, [r1, r2]))
            assert r1.status != "queued" and r2.status == "queued"
            eng.set_tenant_budget("acme", None)              # uncap
            eng.step()
            log.append(_state(eng, [r1, r2]))
            assert r2.status != "queued"
            assert 'tenant="acme"' not in eng.metrics_text()
            _drain(eng, [r1, r2], log)

        _both(scenario, num_blocks=8)


def test_unpublish_same_decisions():
    """One operation sequence through both pools, ``unpublish`` of a
    live block, of an LRU-parked one and of an unpublished one
    included: every returned block and occupancy figure agrees."""
    logs = []
    for mod in (tblocks, jblocks):
        pool = mod.BlockPool(4, 8)
        pool.reserve(3)
        a, b, c = pool.alloc(), pool.alloc(), pool.alloc()
        pool.publish(b"h1", a)
        pool.publish(b"h2", b)
        pool.release(b)                  # b parks in the LRU
        pool.unpublish(a)                # live: only the entry goes
        pool.unpublish(b)                # parked: back to the free list
        pool.unpublish(c)                # never published: no-op
        pool.release(a)                  # a is private now: freed
        pool.reserve(2)
        d, e = pool.alloc(), pool.alloc()
        logs.append([a, b, c, d, e, pool.lookup(b"h1"), pool.lookup(b"h2"),
                     pool.in_use, pool.free_count, pool.cached_free_count,
                     pool.cached_count, pool.evictions, pool.reserved])
    assert logs[0] == logs[1]
