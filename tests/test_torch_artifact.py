"""The serving artifact: ``paddle_tpu``'s artifacts of every format
loaded into the port, and the port's own artifacts, on the CPU.

The JAX artifacts are exported (``paddle_tpu.io.lm_serving.
save_lm_artifact``) with the Pallas kernels in interpret mode, so the
JAX artifact engine's decode and verify tails draw on the hashed stream
the port's wrappers draw; the prefill tail is the threefry stream in
both. Models: ``tests/test_spec_decode.py``'s (vocab 40, 2 layers, rope,
fp32; a 1-layer draft from seed 7), blocks of 8, one chunk bucket of 8.

- A JAX v4 artifact (fp32 pool, int8 pool, int8 weights) and a v5
  artifact (the draft stamped in) load into the port; ``engine()`` is a
  ``PagedDecodeEngine`` or a ``SpecDecodeEngine`` with the stamped
  geometry, and its greedy and sampled ids equal the JAX artifact
  engine's.
- A port save followed by a port load is bitwise: every weight (bf16
  leaves as raw words, int8 codes and fp32 scales) and the meta; the
  loaded engine's ids equal an in-process engine's.
- JAX v1 (plain), v2 (int8 weights) and v3 (slot engine, buckets 8 and
  16) artifacts: ``LMServer.generate`` gives the JAX server's ids,
  greedy, seeded and with the ``eos_id`` early exit; ``engine()`` on v3
  is a ``DecodeEngine`` whose greedy and sampled ids equal the JAX v3
  engine's; on v1/v2 it raises, and on v3 ``chunk_tokens=`` and
  ``tiers=`` raise. The port's v1-v3 round trips are bitwise and serve
  the in-process ids. A v6 artifact raises; an ``.npz`` with an
  ``ml_dtypes.bfloat16`` leaf loads as bf16 with the same words.
"""

import atexit
import contextlib
import functools
import io
import json
import os
import shutil
import tarfile
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch.io import lm_serving as tlm
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.observe import metrics
from paddle_tpu_torch.observe.compile_tracker import CompileTracker
from paddle_tpu_torch.serving import (DecodeEngine, PagedDecodeEngine,
                                      SpecDecodeEngine)

torch.set_num_threads(1)

KW = dict(vocab=40, d_model=16, n_heads=2, n_kv_heads=1, n_layers=2,
          d_ff=32, max_len=64, use_rope=True)
BS = 8
EXPORT = dict(batch=3, prompt_len=8, cache_len=32, engine_buckets=(8,),
              engine_paged=True, engine_block_size=BS)
VARIANTS = {"v4": {}, "v4-int8-pool": {"engine_kv_dtype": "int8"},
            "v4-int8-weights": {"weights_int8": True}, "v5": {"spec": True}}
# the lockstep and slot-engine formats: batch 3, prompts of 8, 32 positions
LOCKSTEP = dict(batch=3, prompt_len=8, cache_len=32)
OLD = {"v1": {}, "v2": {"weights_int8": True},
       "v3": {"engine_buckets": (8, 16)}}
_DIR = tempfile.mkdtemp(prefix="artifacts-")
atexit.register(shutil.rmtree, _DIR, True)


@contextlib.contextmanager
def _pallas_interpret():
    old = os.environ.get("PADDLE_TPU_PALLAS")
    os.environ["PADDLE_TPU_PALLAS"] = "interpret"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_PALLAS")
        else:
            os.environ["PADDLE_TPU_PALLAS"] = old


@functools.lru_cache(maxsize=None)
def _jax_model():
    cfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    dcfg = jt.TransformerConfig(dtype=jnp.float32, **dict(KW, n_layers=1))
    return (cfg, jt.init_params(jax.random.PRNGKey(0), cfg), dcfg,
            jt.init_params(jax.random.PRNGKey(7), dcfg))


@functools.lru_cache(maxsize=None)
def _jax_artifact(variant: str) -> str:
    """The path of a JAX artifact of ``variant``, exported once."""
    cfg, params, dcfg, dparams = _jax_model()
    kw = dict(VARIANTS[variant])
    if kw.pop("spec", False):
        kw.update(engine_draft_params=dparams, engine_draft_config=dcfg,
                  engine_spec_k=3)
    path = os.path.join(_DIR, f"jax-{variant}.tar")
    with _pallas_interpret():
        jlm.save_lm_artifact(path, params, cfg, **EXPORT, **kw)
    return path


@functools.lru_cache(maxsize=None)
def _jax_old_artifact(variant: str) -> str:
    """The path of a JAX v1/v2/v3 artifact of ``variant``, exported once
    (v3's engine modules with the Pallas kernels in interpret mode)."""
    cfg, params, _, _ = _jax_model()
    path = os.path.join(_DIR, f"jax-{variant}.tar")
    with _pallas_interpret():
        jlm.save_lm_artifact(path, params, cfg, **LOCKSTEP, **OLD[variant])
    return path


def _serve(eng, prompts, temperatures):
    reqs = [eng.submit(p, max_new=8, temperature=t, top_k=20 if t else 0)
            for p, t in zip(prompts, temperatures)]
    eng.run_until_idle()
    return [list(map(int, r.tokens)) for r in reqs]


def _prompts(seed, *lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 40, n).astype(np.int32) for n in lens]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8}[t.dtype])


def _leaves_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_leaves_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


class TestJaxArtifacts:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    def test_engine_ids_equal_jax_artifact_engine(self, variant):
        """The port's engine over a JAX artifact: the stamped geometry,
        and greedy and sampled ids equal to the JAX artifact engine's."""
        path = _jax_artifact(variant)
        jsrv = jlm.load_lm_artifact(path)
        srv = tlm.load_lm_artifact(path)
        assert srv.meta == jsrv.meta
        eng = srv.engine(seed=0, device="cpu")
        spec = variant == "v5"
        assert isinstance(eng, SpecDecodeEngine if spec
                          else PagedDecodeEngine)
        assert (eng.batch, eng.cache_len, eng.block_size, eng.num_blocks,
                eng.chunk_tokens, eng.buckets) == (3, 32, BS, 12, 8, (8,))
        assert eng.kv_dtype == VARIANTS[variant].get("engine_kv_dtype",
                                                     "none")
        phase = "engine_verify" if spec else "engine_decode"
        assert eng.decode_flops == \
            srv.meta["cost_analysis"][phase]["flops"]
        if spec:
            assert eng.spec_k == 3 and srv.draft_params is not None
        prompts = _prompts(1, 5, 9, 13)
        temps = (0.0, 0.8, 0.0)
        with _pallas_interpret():
            want = _serve(jsrv.engine(seed=0), prompts, temps)
        assert _serve(eng, prompts, temps) == want

    def test_int8_weights_arrive_as_codes_and_scales(self):
        """The int8-weight artifact's tree keeps its {"q8", "scale"}
        nodes: codes and scales equal to JAX's ``quantize_lm_params``."""
        _, params, _, _ = _jax_model()
        srv = tlm.load_lm_artifact(_jax_artifact("v4-int8-weights"))
        q = jlm.quantize_lm_params(params)
        for name in ("qkv", "mlp_out"):
            node = srv.params["blocks"][name]
            np.testing.assert_array_equal(node["q8"],
                                          np.asarray(q["blocks"][name]["q8"]))
            np.testing.assert_array_equal(
                node["scale"], np.asarray(q["blocks"][name]["scale"]))
        assert srv.meta["weights_int8"] is True

    def test_layout_and_chunk_grid_fences(self):
        """A pool layout other than head-major, and a chunk grid other
        than the stamped one, refuse to build an engine."""
        srv = tlm.load_lm_artifact(_jax_artifact("v4"))
        with pytest.raises(ValueError, match="chunk"):
            srv.engine(chunk_tokens=16, device="cpu")
        srv.meta["engine_paged"]["pool_layout"] = "slot_major"
        with pytest.raises(ValueError, match="slot_major"):
            srv.engine(device="cpu")

    def test_generate_and_server_surface(self):
        """``meta``, ``health()`` and ``metrics_text()`` are the JAX
        server's, before and after a ``generate()`` call, and
        ``engine()`` hands its registry and tracker to the engine."""
        path = _jax_artifact("v4")
        srv = tlm.load_lm_artifact(path)
        jsrv = jlm.load_lm_artifact(path)
        doc = srv.health()
        assert doc["batch"] == 3 and doc["cache_len"] == 32
        assert doc["requests"] == 0 and doc["tokens_generated"] == 0
        assert doc["seconds_since_request"] is None
        assert srv.cfg.vocab == 40 and srv.cfg.dtype == torch.float32
        prompt = _prompts(8, 8, 8, 8)
        got = srv.generate(np.stack(prompt), 5, device="cpu")
        want = jsrv.generate(np.stack(prompt), 5)
        np.testing.assert_array_equal(got, want)
        assert srv.health().keys() == jsrv.health().keys()
        for name in ("requests", "tokens_generated", "decode_steps"):
            assert srv.health()[name] == jsrv.health()[name]
        assert srv.health()["seconds_since_request"] >= 0

        def names(text):
            return {ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE")}

        assert names(srv.metrics_text()) == names(jsrv.metrics_text())
        reg, tracker = metrics.Registry(), CompileTracker()
        eng = srv.engine(registry=reg, tracker=tracker, chunk_tokens=8,
                         device="cpu")
        assert eng.metrics is reg and eng._tracker is tracker
        assert reg.get("engine_requests_total") is not None


class TestJaxLockstepArtifacts:
    @pytest.mark.parametrize("mode", ["greedy", "seeded", "eos"])
    @pytest.mark.parametrize("variant", list(OLD))
    def test_generate_equals_jax_server(self, variant, mode):
        """``LMServer.generate`` over a JAX v1/v2/v3 artifact: the JAX
        server's ids, greedy, seeded at temperature 0.8 (host-side
        ``RandomState`` draws) and with ``eos_id`` (one prompt in every
        row, so every row emits the eos at the same step and the loop
        ends early, padded as JAX pads)."""
        path = _jax_old_artifact(variant)
        jsrv, srv = jlm.load_lm_artifact(path), tlm.load_lm_artifact(path)
        assert srv.meta == jsrv.meta
        assert srv.meta["format_version"] == int(variant[1])
        kw = {"seeded": dict(temperature=0.8, seed=3)}.get(mode, {})
        if mode == "eos":
            prompt = np.stack(_prompts(9, 8) * 3)
            greedy = jsrv.generate(prompt, 10)
            kw = dict(eos_id=int(greedy[0, 8 + 2]))
        else:
            prompt = np.stack(_prompts(9, 8, 8, 8))
        want = jsrv.generate(prompt, 10, **kw)
        got = srv.generate(prompt, 10, device="cpu", **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if mode == "eos":
            assert got.shape[1] < 18 and (got[:, -1] == kw["eos_id"]).all()

    def test_v3_engine_ids_equal_jax_v3_engine(self):
        """``engine()`` on a JAX v3 artifact: a ``DecodeEngine`` with the
        stamped batch, cache length, buckets and decode FLOPs, whose
        greedy and sampled ids equal the JAX v3 engine's."""
        path = _jax_old_artifact("v3")
        jsrv, srv = jlm.load_lm_artifact(path), tlm.load_lm_artifact(path)
        eng = srv.engine(seed=0, device="cpu")
        assert type(eng) is DecodeEngine
        assert (eng.batch, eng.cache_len, eng.buckets) == (3, 32, (8, 16))
        assert eng.decode_flops == \
            srv.meta["cost_analysis"]["engine_decode"]["flops"]
        prompts = _prompts(10, 5, 9, 13, 3)
        temps = (0.0, 0.8, 0.0, 0.8)
        with _pallas_interpret():
            want = _serve(jsrv.engine(seed=0), prompts, temps)
        assert _serve(eng, prompts, temps) == want

    def test_engine_errors(self):
        """v1/v2 carry no engine; the row arena takes no chunk grid and no
        spill tiers: each raises, as the JAX server does."""
        for variant in ("v1", "v2"):
            with pytest.raises(ValueError, match="no engine modules"):
                tlm.load_lm_artifact(_jax_old_artifact(variant)).engine(
                    device="cpu")
        srv = tlm.load_lm_artifact(_jax_old_artifact("v3"))
        with pytest.raises(ValueError, match="chunk_tokens=8"):
            srv.engine(chunk_tokens=8, device="cpu")
        with pytest.raises(ValueError, match="tiers="):
            srv.engine(tiers={"dram_bytes": 1 << 20}, device="cpu")

    def test_generate_checks_raise_as_jax(self):
        srv = tlm.load_lm_artifact(_jax_old_artifact("v1"))
        prompt = np.stack(_prompts(11, 8, 8, 8))
        with pytest.raises(ValueError, match="max_new must be >= 1"):
            srv.generate(prompt, 0, device="cpu")
        with pytest.raises(ValueError, match="exported for batch=3"):
            srv.generate(prompt[:2], 4, device="cpu")
        with pytest.raises(ValueError, match="exported for batch=3"):
            srv.generate(prompt[:, :6], 4, device="cpu")
        with pytest.raises(ValueError, match="exceed the exported cache_len"):
            srv.generate(prompt, 30, device="cpu")


def _write_tar(path, meta, members):
    with tarfile.open(path, "w") as tar:
        for name, data in [("meta.json", json.dumps(meta).encode()),
                           *members.items()]:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class TestPortArtifacts:
    @pytest.mark.parametrize("spec", [False, True], ids=["v4", "v5"])
    def test_roundtrip_is_bitwise(self, spec, tmp_path):
        """A bf16 serving tree saved by the port and loaded again: every
        leaf's words equal (bf16 matmul weights, fp32 others), the meta
        carries the geometry, and the loaded engine's greedy ids equal
        an in-process engine's over the same weights."""
        cfg = tt.TransformerConfig(dtype="bfloat16", **KW)
        dcfg = tt.TransformerConfig(dtype="bfloat16", **dict(KW, n_layers=1))
        params = tt.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        draft = tt.init_params(dcfg, torch.Generator().manual_seed(4), "cpu")
        kw = dict(engine_draft_params=draft, engine_draft_config=dcfg,
                  engine_spec_k=2) if spec else {}
        path = str(tmp_path / "port.tar")
        tlm.save_lm_artifact(path, params, cfg, **EXPORT,
                             engine_num_blocks=10, **kw)
        with tarfile.open(path) as tar:
            names = sorted(m.name for m in tar.getmembers())
        assert names == sorted(["meta.json", "params.npz"]
                               + (["draft_params.npz"] if spec else []))
        srv = tlm.load_lm_artifact(path)
        assert srv.meta["format_version"] == (5 if spec else 4)
        assert srv.meta["engine_paged"]["num_blocks"] == 10
        assert srv.cfg == cfg
        assert srv.params["blocks"]["qkv"].dtype == torch.bfloat16
        eng = srv.engine(seed=0, device="cpu")
        assert _leaves_equal(eng.params, params)
        prompts = _prompts(2, 5, 11)
        if spec:
            assert _leaves_equal(eng.draft_params, draft)
            assert srv.draft_params is not None and eng.spec_k == 2
            ref = SpecDecodeEngine.from_params(
                params, cfg, draft, dcfg, spec_k=2, batch=3, cache_len=32,
                block_size=BS, num_blocks=10, chunk_tokens=8, seed=0,
                device="cpu")
        else:
            ref = PagedDecodeEngine.from_params(
                params, cfg, batch=3, cache_len=32, block_size=BS,
                num_blocks=10, chunk_tokens=8, seed=0, device="cpu")
        assert _serve(eng, prompts, (0.0, 0.0)) == \
            _serve(ref, prompts, (0.0, 0.0))

    def test_int8_weights_roundtrip(self, tmp_path):
        """``weights_int8=True`` stores ``quantize_lm_params`` of the fp32
        tree; a load gives the codes and scales back bitwise and the
        engine serves them as int8 weights."""
        cfg = tt.TransformerConfig(dtype="float32", **KW)
        fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(5),
                                    "cpu")
        path = str(tmp_path / "w8.tar")
        tlm.save_lm_artifact(path, fp32, cfg, weights_int8=True, **EXPORT)
        srv = tlm.load_lm_artifact(path)
        assert srv.meta["weights_int8"] is True
        eng = srv.engine(device="cpu")
        want = tlm.quantize_lm_params(fp32, device="cpu")
        assert _leaves_equal(eng.params["blocks"]["qkv"],
                             want["blocks"]["qkv"])
        assert _leaves_equal(eng.params["embed"], want["embed"])
        assert len(_serve(eng, _prompts(3, 6), (0.0,))[0]) == 8

    def test_saves_only_the_paged_formats(self, tmp_path):
        """The save's checks raise as the JAX package's: a quantized pool
        or a draft without the paged engine, a paged save without
        buckets, a block grid that does not divide the chunk."""
        cfg = tt.TransformerConfig(dtype="float32", **KW)
        params = tt.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
        with pytest.raises(ValueError, match="engine_kv_dtype needs"):
            tlm.save_lm_artifact(str(tmp_path / "a.tar"), params, cfg,
                                 **LOCKSTEP, engine_buckets=(8,),
                                 engine_kv_dtype="int8")
        with pytest.raises(ValueError, match="needs engine_paged"):
            tlm.save_lm_artifact(str(tmp_path / "a.tar"), params, cfg,
                                 **LOCKSTEP, engine_draft_params=params,
                                 engine_draft_config=cfg)
        with pytest.raises(ValueError, match="needs engine_buckets"):
            tlm.save_lm_artifact(str(tmp_path / "a.tar"), params, cfg,
                                 **LOCKSTEP, engine_paged=True)
        with pytest.raises(ValueError, match="block_size"):
            tlm.save_lm_artifact(str(tmp_path / "b.tar"), params, cfg,
                                 **dict(EXPORT, engine_block_size=3))

    @pytest.mark.parametrize("variant", list(OLD))
    def test_lockstep_roundtrip_is_bitwise(self, variant, tmp_path):
        """A port save of v1 (a bf16 serving tree), v2 (int8 weights of an
        fp32 tree) or v3 (the bf16 tree with buckets 8 and 16) loaded
        again: the format number, meta and every leaf's words; the loaded
        server's greedy ``generate`` equals ``transformer.generate`` on
        the saved tree, and v3's engine the in-process slot engine's
        greedy ids."""
        int8 = variant == "v2"
        cfg = tt.TransformerConfig(dtype="float32" if int8 else "bfloat16",
                                   **KW)
        gen = torch.Generator().manual_seed(8)
        params = (tt.init_train_params(cfg, gen, "cpu") if int8
                  else tt.init_params(cfg, gen, "cpu"))
        path = str(tmp_path / f"{variant}.tar")
        tlm.save_lm_artifact(path, params, cfg, **LOCKSTEP, **OLD[variant])
        srv = tlm.load_lm_artifact(path)
        assert srv.meta["format_version"] == int(variant[1])
        assert srv.meta["weights_int8"] is int8 and srv.cfg == cfg
        assert srv.meta.get("engine_buckets") == \
            (list(OLD[variant]["engine_buckets"]) if variant == "v3"
             else None)
        served = tt.params_from_numpy(srv.params, cfg, device="cpu")
        want = (tlm.quantize_lm_params(params, device="cpu") if int8
                else params)
        assert _leaves_equal(served, want)
        prompt = np.stack(_prompts(12, 8, 8, 8))
        ids = tt.generate(want, torch.from_numpy(prompt), cfg, max_new=6)
        np.testing.assert_array_equal(srv.generate(prompt, 6, device="cpu"),
                                      ids.numpy())
        if variant != "v3":
            return
        prompts = _prompts(13, 5, 11, 16)
        ref = DecodeEngine.from_params(want, cfg, batch=3, cache_len=32,
                                       buckets=(8, 16), seed=0,
                                       device="cpu")
        assert _serve(srv.engine(seed=0, device="cpu"), prompts,
                      (0.0,) * 3) == _serve(ref, prompts, (0.0,) * 3)

    def test_newer_format_raises(self, tmp_path):
        path = str(tmp_path / "v6.tar")
        _write_tar(path, {"format_version": 6}, {})
        with pytest.raises(ValueError, match="newer"):
            tlm.load_lm_artifact(path)

    def test_ml_dtypes_bfloat16_leaf_loads_with_its_words(self, tmp_path):
        """An ``.npz`` leaf saved from an ``ml_dtypes.bfloat16`` array
        (numpy writes it as raw ``|V2`` words) loads as a bf16 tensor
        with the same words, without ``ml_dtypes`` in the port."""
        rng = np.random.RandomState(7)
        w = rng.randn(3, 5).astype(ml_dtypes.bfloat16)
        path = str(tmp_path / "bf16.tar")
        meta = {"format_version": 4, "batch": 1, "prompt_len": 8,
                "cache_len": 16, "config": dict(KW, dtype="bfloat16")}
        _write_tar(path, meta, {"params.npz": _npz(
            **{"blocks/qkv": w, "ln_f": np.ones(16, np.float32)})})
        srv = tlm.load_lm_artifact(path)
        leaf = srv.params["blocks"]["qkv"]
        assert leaf.dtype == torch.bfloat16 and leaf.shape == (3, 5)
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      w.view(np.int16))
        assert isinstance(srv.params["ln_f"], np.ndarray)

    def test_config_refuses_what_the_port_does_not_serve(self):
        """JAX config fields the port does not read must hold their
        defaults; the dtype name maps to torch's."""
        base = dict(KW, dtype="bfloat16", cp_mode="ring",
                    use_flash_attention=False, moe_top_k=1,
                    moe_capacity_factor=1.25, moe_aux_weight=0.01)
        assert tlm._cfg_from_dict(base).dtype == torch.bfloat16
        with pytest.raises(ValueError, match="cp_mode"):
            tlm._cfg_from_dict(dict(base, cp_mode="allgather"))
        assert tlm._cfg_to_dict(tlm._cfg_from_dict(base))["dtype"] == \
            "bfloat16"

    def test_flatten_roundtrip_with_lists(self):
        """The JAX checkpoint path encoding: '/'-joined keys, list items
        as ``__<i>``; ``_unflatten`` rebuilds lists with no template."""
        tree = {"a": {"b": np.ones(2)}, "c": [np.zeros(1), {"d": np.ones(3)}]}
        flat = tlm._flatten(tree)
        assert sorted(flat) == ["a/b", "c/__0", "c/__1/d"]
        back = tlm._unflatten(flat)
        assert isinstance(back["c"], list) and back["c"][1]["d"].shape == (3,)
