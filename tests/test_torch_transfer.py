"""The PTKV block wire, the spill tiers and the engine's prefix mobility
against ``paddle_tpu``'s, on the CPU.

- ``serving/transfer.py``: pools holding the same seeded values (fp32,
  bf16, int8, int4) serialize to the same payload bytes in both
  packages; a JAX payload writes into the port's pool, and a port
  payload into the JAX pool, byte for byte; ``check_pool_match``
  refuses a wrong layout, kv_dtype or block size on both sides; a
  malformed payload raises on both.
- ``serving/tiers.py``: a PTT1 file written by either ``TieredStore``
  reads in the other, and the ``TestTieredStore`` cases of
  ``tests/test_tiered_cache.py`` hold on the port.
- The engines: a prefix exported by either engine and imported by the
  other, and prefixes promoted from DRAM or disk after eviction, give
  the JAX engine's greedy ids and its tier counters, for the pool
  storages none / int8 / int4; an import writes the pool in place.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jt
from paddle_tpu.serving import PagedDecodeEngine as JaxEngine
from paddle_tpu.serving import blocks as jblocks
from paddle_tpu.serving import tiers as jtiers
from paddle_tpu.serving import transfer as jtransfer
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import chrome_trace as tchrome
from paddle_tpu_torch.serving import PagedDecodeEngine
from paddle_tpu_torch.serving import tiers as ttiers
from paddle_tpu_torch.serving import transfer as ttransfer
from paddle_tpu_torch.serving.tiers import TieredStore

torch.set_num_threads(1)

KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
BS = 8
POOLS = {"fp32": (None, jnp.float32, torch.float32),
         "bf16": (None, jnp.bfloat16, torch.bfloat16),
         "int8": ("int8", jnp.float32, torch.float32),
         "int4": ("int4", jnp.float32, torch.float32)}


def _pools(kind, nb=6, seed=0):
    """(JAX pool, port pool) of ``nb`` blocks holding the same seeded
    bytes."""
    kvd, jdt, tdt = POOLS[kind]
    jcfg = jt.TransformerConfig(dtype=jdt, **KW)
    tcfg = tt.TransformerConfig(dtype=tdt, **KW)
    jpool = jt.init_block_pool(jcfg, nb, BS, kv_dtype=kvd)
    tpool = tt.init_block_pool(tcfg, nb, BS, kv_dtype=kvd, device="cpu")
    rng = np.random.RandomState(seed)
    out_j = {}
    for n, leaf in jpool.items():
        t = tpool[n]
        if t.dtype == torch.int8:
            vals = rng.randint(-128, 128, t.shape).astype(np.int8)
            t.copy_(torch.from_numpy(vals))
            out_j[n] = jnp.asarray(vals)
        elif t.dtype == torch.bfloat16:
            vals = (rng.randn(*t.shape) * 0.5).astype(np.float32)
            t.copy_(torch.from_numpy(vals).to(torch.bfloat16))
            out_j[n] = jnp.asarray(vals).astype(jnp.bfloat16)
        else:
            vals = rng.rand(*t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(vals))
            out_j[n] = jnp.asarray(vals)
    return out_j, tpool, kvd or "none"


def _pool_bytes(pool) -> dict:
    out = {}
    for n, a in pool.items():
        if isinstance(a, torch.Tensor):
            out[n] = a.contiguous().view(torch.uint8).numpy().tobytes()
        else:
            out[n] = np.ascontiguousarray(np.asarray(a)).tobytes()
    return out


def _digests(n):
    return [bytes([i + 1]) * 16 for i in range(n)]


@pytest.mark.parametrize("kind", list(POOLS))
def test_payload_bytes_equal(kind):
    jpool, tpool, kvd = _pools(kind)
    ids, dig = [3, 0, 5], _digests(3)
    jpay = jtransfer.serialize_blocks(jpool, ids, dig, BS, kvd, trace="t.1")
    tpay = ttransfer.serialize_blocks(tpool, ids, dig, BS, kvd, trace="t.1")
    assert tpay == jpay
    assert ttransfer.pool_meta(tpool, BS, kvd) == \
        jtransfer.pool_meta(jpool, BS, kvd)
    # the factored path gives the same bytes
    raw = ttransfer.serialize_raw_blocks(
        ttransfer.pool_meta(tpool, BS, kvd),
        list(zip(dig, ttransfer.read_blocks(tpool, ids, BS))), trace="t.1")
    assert raw == jpay


@pytest.mark.parametrize("kind", list(POOLS))
def test_payloads_cross_byte_for_byte(kind):
    jsrc, tsrc, kvd = _pools(kind, seed=1)
    jdst, tdst, _ = _pools(kind, seed=2)
    ids, dst_ids, dig = [4, 1], [2, 5], _digests(2)
    # JAX -> port
    meta, items = ttransfer.deserialize_blocks(
        jtransfer.serialize_blocks(jsrc, ids, dig, BS, kvd))
    ttransfer.check_pool_match(meta, tdst, BS, kvd)
    assert [d for d, _ in items] == dig
    ptrs = {n: t.data_ptr() for n, t in tdst.items()}
    ttransfer.write_blocks(tdst, [(b, a) for b, (_, a) in
                                  zip(dst_ids, items)], BS)
    assert {n: t.data_ptr() for n, t in tdst.items()} == ptrs
    # port -> JAX
    meta, jitems = jtransfer.deserialize_blocks(
        ttransfer.serialize_blocks(tsrc, ids, dig, BS, kvd))
    jtransfer.check_pool_match(meta, jdst, BS, kvd)
    jdst = jtransfer.write_blocks(jdst, [(b, a) for b, (_, a) in
                                         zip(dst_ids, jitems)], BS)
    src, got_t, got_j = (_pool_bytes(p) for p in (tsrc, tdst, jdst))
    for n in src:
        # every written row equals its source row in both pools, and
        # the two destinations are the same bytes throughout
        row = len(src[n]) // (tsrc[n].shape[0] * tsrc[n].shape[1]
                              * tsrc[n].shape[2])
        s = np.frombuffer(src[n], np.uint8).reshape(
            *tsrc[n].shape[:3], row)
        for pool_b in (got_t[n], got_j[n]):
            d = np.frombuffer(pool_b, np.uint8).reshape(s.shape)
            for sb, db in zip(ids, dst_ids):
                assert np.array_equal(d[:, :, db * BS:(db + 1) * BS],
                                      s[:, :, sb * BS:(sb + 1) * BS])
        assert got_t[n] == got_j[n]


@pytest.mark.parametrize("key,value", [
    ("layout", "slot_major"), ("kv_dtype", "int8"), ("block_size", 16)])
def test_check_pool_match_refuses_on_both_sides(key, value):
    jpool, tpool, kvd = _pools("fp32")
    for mod, pool in ((jtransfer, jpool), (ttransfer, tpool)):
        meta, _ = mod.deserialize_blocks(
            mod.serialize_blocks(pool, [0], _digests(1), BS, kvd))
        mod.check_pool_match(meta, pool, BS, kvd)
        bad = dict(meta, **{key: value})
        with pytest.raises(ValueError, match=f"KV payload {key} mismatch"):
            mod.check_pool_match(bad, pool, BS, kvd)
    # a pool of another storage refuses the fp32 stamp
    _, t8, _ = _pools("int8")
    meta, _ = ttransfer.deserialize_blocks(
        ttransfer.serialize_blocks(tpool, [0], _digests(1), BS, kvd))
    with pytest.raises(ValueError, match="mismatch"):
        ttransfer.check_pool_match(meta, t8, BS, "int8")


def test_malformed_payloads_raise_on_both_sides():
    jpool, tpool, kvd = _pools("int4")
    pay = ttransfer.serialize_blocks(tpool, [1, 2], _digests(2), BS, kvd)
    cases = {"magic": b"XXXX" + pay[4:], "truncated": pay[:-7],
             "trailing": pay + b"\0",
             "version": pay[:4] + (2).to_bytes(4, "little") + pay[8:]}
    for name, bad in cases.items():
        for mod in (jtransfer, ttransfer):
            with pytest.raises(ValueError):
                mod.deserialize_blocks(bad)
    with pytest.raises(ValueError, match="digests"):
        ttransfer.serialize_blocks(tpool, [1], _digests(2), BS, kvd)


# -- the spill store ---------------------------------------------------------

def _payload(seed, n=600):
    return np.random.RandomState(seed).bytes(n)


@pytest.mark.parametrize("writer,reader", [(jtiers, ttiers),
                                           (ttiers, jtiers)],
                         ids=["jax-to-port", "port-to-jax"])
def test_ptt1_files_read_across(writer, reader, tmp_path):
    w = writer.TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                           disk_dir=str(tmp_path))
    for i in range(3):
        w.put(bytes([i]) * 16, _payload(40 + i))
    r = reader.TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                           disk_dir=str(tmp_path))
    for i in range(3):
        assert r.get(bytes([i]) * 16) == ("disk", _payload(40 + i))
    f = tmp_path / ((bytes([1]) * 16).hex() + ".kv")
    raw = f.read_bytes()
    assert raw[:4] == b"PTT1" and len(raw) == 600 + 20
    # a bit flip written by one is a quarantined miss in the other
    w.put(bytes([9]) * 16, _payload(50))
    f = tmp_path / ((bytes([9]) * 16).hex() + ".kv")
    flipped = bytearray(f.read_bytes())
    flipped[100] ^= 1
    f.write_bytes(bytes(flipped))
    r2 = reader.TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                            disk_dir=str(tmp_path))
    assert r2.get(bytes([9]) * 16) is None
    assert (tmp_path / (f.name + ".corrupt")).exists()


class TestTieredStore:
    """``tests/test_tiered_cache.py::TestTieredStore`` on the port."""

    def test_dram_roundtrip_bitwise(self, tmp_path):
        st = TieredStore(dram_bytes=1 << 20, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path))
        pay = _payload(0)
        st.put(b"a" * 16, pay)
        assert st.tier_of(b"a" * 16) == "dram"
        tier, got = st.get(b"a" * 16)
        assert (tier, got) == ("dram", pay)
        assert st.get(b"x" * 16) is None

    def test_dram_pressure_cascades_to_disk_oldest_first(self, tmp_path):
        pay = _payload(1)
        st = TieredStore(dram_bytes=len(pay) * 2 + 10,
                         disk_bytes=1 << 20, disk_dir=str(tmp_path))
        digests = [bytes([i]) * 16 for i in range(4)]
        for i, d in enumerate(digests):
            st.put(d, _payload(10 + i, len(pay)))
        assert st.tier_of(digests[3]) == "dram"
        assert st.tier_of(digests[2]) == "dram"
        assert st.tier_of(digests[0]) == "disk"
        assert st.tier_of(digests[1]) == "disk"
        tier, got = st.get(digests[0])
        assert tier == "disk" and got == _payload(10, len(pay))

    def test_disk_budget_evicts_oldest(self, tmp_path):
        pay = _payload(2, 500)
        blob = len(pay) + 20          # magic + checksum overhead
        st = TieredStore(dram_bytes=0, disk_bytes=blob * 2 + 10,
                         disk_dir=str(tmp_path))
        digests = [bytes([i]) * 16 for i in range(4)]
        for i, d in enumerate(digests):
            st.put(d, _payload(20 + i, len(pay)))
        assert st.tier_of(digests[0]) is None
        assert st.tier_of(digests[1]) is None
        assert st.tier_of(digests[3]) == "disk"
        assert st.disk_used <= blob * 2 + 10

    def test_restart_scan_readopts_and_clears_temps(self, tmp_path):
        st = TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path))
        st.put(b"a" * 16, _payload(3))
        st.put(b"b" * 16, _payload(4))
        (tmp_path / ".tmp-deadbeef.123").write_bytes(b"torn")
        st2 = TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                          disk_dir=str(tmp_path))
        assert st2.tier_of(b"a" * 16) == "disk"
        tier, got = st2.get(b"b" * 16)
        assert tier == "disk" and got == _payload(4)
        assert not list(tmp_path.glob(".tmp-*"))

    def test_bit_flip_is_quarantined_miss(self, tmp_path):
        st = TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path))
        st.put(b"a" * 16, _payload(5))
        [f] = list(tmp_path.glob("*.kv"))
        raw = bytearray(f.read_bytes())
        raw[len(raw) // 2] ^= 0x40
        f.write_bytes(bytes(raw))
        assert st.get(b"a" * 16) is None
        assert st.tier_of(b"a" * 16) is None
        assert not list(tmp_path.glob("*.kv"))
        assert list(tmp_path.glob("*.corrupt"))
        assert st.metrics.get("engine_tier_corrupt_total").value() == 1

    def test_truncated_file_is_quarantined_miss(self, tmp_path):
        st = TieredStore(dram_bytes=0, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path))
        st.put(b"a" * 16, _payload(6))
        [f] = list(tmp_path.glob("*.kv"))
        f.write_bytes(f.read_bytes()[:25])
        assert st.get(b"a" * 16) is None
        assert st.metrics.get("engine_tier_corrupt_total").value() == 1

    def test_dram_only_overflow_drops(self):
        pay = _payload(7)
        st = TieredStore(dram_bytes=len(pay) + 10)
        st.put(b"a" * 16, pay)
        st.put(b"b" * 16, _payload(8, len(pay)))
        assert st.tier_of(b"a" * 16) is None
        assert st.tier_of(b"b" * 16) == "dram"
        assert st.metrics.get(
            "engine_tier_evictions_total").value(tier="dram") == 1

    def test_gauges_track_occupancy(self, tmp_path):
        st = TieredStore(dram_bytes=1 << 20, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path))
        st.put(b"a" * 16, _payload(9))
        g = st.metrics.get("engine_tier_bytes")
        assert g.value(tier="dram") > 0
        assert g.value(tier="disk") == 0
        assert st.metrics.get(
            "engine_tier_entries").value(tier="dram") == 1


# -- the engines ------------------------------------------------------------

ENGINE = dict(batch=2, cache_len=64, block_size=BS, num_blocks=12,
              chunk_tokens=16, seed=0)
COUNTERS = ("engine_prefix_tier_hit_blocks_total",
            "engine_prefix_tier_miss_blocks_total",
            "engine_tier_demotions_total", "engine_tier_promotions_total")


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_engine(kvd=None, **kw):
    jcfg, jp, _, _ = _model()
    return JaxEngine.from_params(jp, jcfg, pallas="off", kv_dtype=kvd,
                                 decode_flops=1e6, **dict(ENGINE, **kw))


def _port_engine(kvd=None, **kw):
    _, _, tcfg, tp = _model()
    return PagedDecodeEngine.from_params(tp, tcfg, device="cpu",
                                         kv_dtype=kvd, **dict(ENGINE, **kw))


def _run(eng, prompt, max_new=4):
    r = eng.submit(prompt, max_new)
    eng.run_until_idle()
    return list(map(int, r.output))


def _churn(eng, n=6, seed=100):
    for i in range(n):
        _run(eng, np.random.RandomState(seed + i).randint(0, 40, 30)
             .astype(np.int32), 2)


def _warm_prompt(seed=7):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(0, 40, 16),
                           rng.randint(0, 40, 8)]).astype(np.int32)


def _rows(cache, b) -> dict:
    """The bytes of block ``b``'s rows of every leaf of an fp32, int8 or
    int4 pool (either package's)."""
    out = {}
    for n, v in cache.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[n] = np.ascontiguousarray(a[:, :, b * BS:(b + 1) * BS]).tobytes()
    return out


def _counters(eng) -> dict:
    out = {}
    for name in COUNTERS:
        m = eng.metrics.get(name)
        out[name] = {t: int(m.value(tier=t)) for t in ("hbm", "dram", "disk")}
    out["corrupt"] = int(eng.metrics.get("engine_tier_corrupt_total")
                         .value())
    out["imported"] = int(eng.metrics.get(
        "engine_kv_blocks_imported_total").value())
    return out


def _tiered(eng, corrupt_dir=None):
    prompt = _warm_prompt()
    ids = [_run(eng, prompt)]
    _churn(eng)
    if corrupt_dir is not None:
        for f in sorted(corrupt_dir.glob("*.kv")):
            raw = bytearray(f.read_bytes())
            raw[-3] ^= 0xFF
            f.write_bytes(bytes(raw))
    ids.append(_run(eng, prompt))
    return ids, _counters(eng)


@pytest.mark.parametrize("kvd", [None, "int8", "int4"])
def test_dram_readopt_equals_jax(kvd):
    cold = _run(_jax_engine(kvd), _warm_prompt())
    want = _tiered(_jax_engine(kvd, tiers={"dram_bytes": 1 << 20}))
    eng = _port_engine(kvd, tiers={"dram_bytes": 1 << 20})
    ptrs = {n: t.data_ptr() for n, t in eng.cache.items()}
    got = _tiered(eng)
    assert got == want
    assert got[0] == [cold, cold]
    assert got[1]["engine_prefix_tier_hit_blocks_total"]["dram"] >= 2
    assert {n: t.data_ptr() for n, t in eng.cache.items()} == ptrs
    assert eng.pool.idle


def test_disk_readopt_and_corrupt_spill_equal_jax(tmp_path):
    cold = _run(_jax_engine(), _warm_prompt())
    for corrupt in (False, True):
        runs = []
        for side, make in (("jax", _jax_engine), ("port", _port_engine)):
            d = tmp_path / f"{side}{int(corrupt)}"
            eng = make(tiers={"dram_bytes": 1, "disk_bytes": 1 << 20,
                              "disk_dir": str(d)})
            runs.append(_tiered(eng, d if corrupt else None))
        assert runs[1] == runs[0]
        ids, c = runs[1]
        assert ids == [cold, cold]
        if corrupt:
            assert c["corrupt"] >= 1
            assert c["engine_prefix_tier_hit_blocks_total"]["disk"] == 0
        else:
            assert c["corrupt"] == 0
            assert c["engine_prefix_tier_hit_blocks_total"]["disk"] >= 2


def test_spill_payload_is_the_wire_and_health_lists_tiers(tmp_path):
    eng = _port_engine(tiers={"dram_bytes": 1 << 20, "disk_bytes": 1 << 20,
                              "disk_dir": str(tmp_path)})
    _run(eng, _warm_prompt())
    _churn(eng)
    d0 = bytes.fromhex(eng.tiers.digests()["dram"][0])
    tier, payload = eng.tiers.get(d0)
    for mod, pool in ((ttransfer, eng.cache),
                      (jtransfer, _jax_engine().cache)):
        meta, items = mod.deserialize_blocks(payload)
        mod.check_pool_match(meta, pool, BS, "none")
        assert len(items) == 1 and items[0][0] == d0
    doc = eng.health()
    jdoc = _jax_engine(tiers={"dram_bytes": 1 << 20}).health()
    assert doc["flops_per_token"] > 0
    t = doc["tiers"]
    assert set(t) == set(jdoc["tiers"])
    assert t["dram"]["entries"] > 0
    assert t["dram"]["capacity_bytes"] == 1 << 20
    assert set(t["digests"]) == {"hbm", "dram", "disk"}
    assert t["digests"]["dram"] and t["digests"]["hbm"]
    assert _port_engine().health()["tiers"] == {"digests": {"hbm": []}}


@pytest.mark.parametrize("kvd", [None, "int8", "int4"])
def test_prefix_crosses_engines(kvd):
    """A prefix exported by either engine imports into the other; the
    greedy ids over the adopted blocks equal the cold run's, the
    adopted rows equal the sender's, and the port's pool tensors keep
    their addresses."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 40, 40).astype(np.int32)     # 2 chunks + 8
    cold = _run(_jax_engine(kvd), prompt)
    for src_make, dst_make in ((_jax_engine, _port_engine),
                               (_port_engine, _jax_engine)):
        src = src_make(kvd)
        _run(src, prompt, max_new=1)
        payload = src.export_prefix(prompt, trace="fleet.7")
        assert payload is not None
        dst = dst_make(kvd)
        _run(dst, rng.randint(0, 40, 20).astype(np.int32), 2)   # warm
        ptrs = ({n: t.data_ptr() for n, t in dst.cache.items()}
                if isinstance(dst, PagedDecodeEngine) else None)
        assert dst.import_prefix(payload) == 4
        assert dst.import_prefix(payload) == 0              # all cached
        digests = dst.prefix_digests(prompt)
        assert digests == src.prefix_digests(prompt) and len(digests) == 4
        for h in digests:
            assert _rows(dst.cache, dst.pool.lookup(h)) == \
                _rows(src.cache, src.pool.lookup(h))
        r = dst.submit(prompt, 4)
        dst.run_until_idle()
        assert list(map(int, r.output)) == cold
        assert r.prefix_hit_tokens == 32
        assert int(dst.metrics.get(
            "engine_kv_blocks_imported_total").value()) == 4
        if ptrs is not None:
            assert {n: t.data_ptr() for n, t in dst.cache.items()} == ptrs
            evs = [s for s in tchrome.default_buffer().spans()
                   if s[6] == "fleet.7" and s[0] == "prefix_import"]
            assert [e[4] for e in evs[-2:]] == [{"blocks": 4, "chain": 4},
                                                {"blocks": 0, "chain": 4}]


def test_import_refuses_another_pool_and_partial_export(tmp_path):
    prompt = np.random.RandomState(4).randint(0, 40, 40).astype(np.int32)
    src = _port_engine("int8")
    _run(src, prompt, 1)
    payload = src.export_prefix(prompt)
    dst = _port_engine()
    with pytest.raises(ValueError, match="mismatch"):
        dst.import_prefix(payload)
    assert dst.pool.cached_count == 0
    assert src.export_prefix(prompt[:8]) is None             # no prefix
    # partial export: evict the chain to the tiers, then serve its
    # leading run from DRAM; the full export refuses
    eng = _port_engine(tiers={"dram_bytes": 1 << 20})
    _run(eng, prompt, 1)
    _churn(eng)
    assert all(eng.pool.lookup(h) is None
               for h in eng.prefix_digests(prompt))
    assert eng.export_prefix(prompt) is None
    part = eng.export_prefix(prompt, partial=True)
    hot = _port_engine()
    _run(hot, prompt, 1)
    assert part == hot.export_prefix(prompt)        # the same bytes
    meta, items = ttransfer.deserialize_blocks(part)
    assert [d for d, _ in items] == eng.prefix_digests(prompt)
    fresh = _port_engine()
    assert fresh.import_prefix(part) == 4
    assert _run(fresh, prompt) == _run(_port_engine(), prompt)
    assert jblocks.prompt_block_hashes(prompt, BS)[:4] == \
        eng.prefix_digests(prompt)
