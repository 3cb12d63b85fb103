"""The transformer's mesh paths that the port runs as the JAX package
runs them under GSPMD, on 4 gloo ranks (``tests/torch_dist_util.pool``,
rank cases ``case_mesh_loss`` / ``case_mesh_serve`` in
``tests/torch_dist_cases.py``), at ``tests/test_torch_ring.py``'s small
widths in fp32, the weights exported from the JAX tree through numpy:

- dropout under a mesh: every dropout site draws the global mask and
  keeps the rank's block, so the sharded step from equal generator
  seeds is the port's own unsharded step (the port's masks are
  generator draws, never JAX's threefry masks); without a generator the
  same configs are JAX's unsharded step;
- a ``seq`` axis without ring attention: the global sequence gathered
  (kernel 5/6's plain version, or the plain attention with ragged
  ``lengths``);
- ``prefill`` / ``prefill_into_slot`` / ``generate`` / ``beam_search``
  with ``mesh=``: global logits, arena and ids on every rank; the decode
  steps run on the whole tree, gathered once a call (ROADMAP C16);
- the refusals that stay: the int8 tree in the mesh forward, and splits
  that do not divide (where the JAX function raises too).

The reference has no test of these paths under a mesh, so each JAX
function under a JAX mesh of the same shape (8 virtual CPU devices,
``tests/conftest.py``) is first held to the JAX function unsharded.

Tolerances: loss within 1e-5 relative and each gradient shard within
1e-5 of its leaf's max (TOL); prefill logits and arenas within 1e-4
absolute (ATOL, two frameworks' fp32 matmuls); ids exact, beam scores
within 1e-4. Under ``remat="bf16"`` the gradients against JAX's are
held to 1e-4 of a leaf's max: the two packages' x differ by ulps, so a
bf16 stash element can round the other way
(``tests/test_torch_remat.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.core import place as jplace
from paddle_tpu.io import lm_serving as jlm
from paddle_tpu.models import transformer as jtt
from tests.torch_dist_util import pool

TOL = 1e-5
ATOL = 1e-4
REMAT_TOL = 1e-4
AXES = ("data", "seq", "model")
CFG = dict(vocab=50, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=32)


def _flat(tree, prefix="p/"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _model(extra=(), seed=1, int8=False):
    """(JAX config, JAX parameters, their numpy inputs) for ``CFG``
    updated by ``extra`` (a tuple of items)."""
    kw = dict(CFG, **dict(extra))
    jcfg = jtt.TransformerConfig(**kw, dtype=jnp.float32)
    params = jtt.init_params(jax.random.PRNGKey(seed), jcfg)
    if int8:
        params = jlm.quantize_lm_params(params)
    return jcfg, params, _flat(params)


def _tokens(seed, B, T, vocab=CFG["vocab"]):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int64)


def _jleaf(tree, name):
    return np.asarray(tree["blocks"][name[7:]] if name.startswith("blocks/")
                      else tree[name])


def _jax_loss_grads(params, cfg, toks, tgt, lens=None, mesh=None):
    ln = None if lens is None else jnp.asarray(lens, jnp.int32)
    return jax.value_and_grad(lambda p: jtt.lm_loss(
        p, jnp.asarray(toks, jnp.int32), jnp.asarray(tgt, jnp.int32), cfg,
        lengths=ln, mesh=mesh))(params)


def _check_grads(grads, want_of, tol=TOL):
    for name, (gg, sl) in grads.items():
        want = want_of(name)
        piece = want[tuple(slice(a, b) for a, b in sl)]
        err = float(np.abs(gg - piece).max())
        assert err <= tol * np.abs(want).max(), (name, err)


def _close(got, want, label, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, (label, err)


def _same_on_every_rank(res, *keys):
    for r in res[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# dropout under a mesh
# ---------------------------------------------------------------------------

RING = (("use_ring_attention", True),)
MOE = (("moe_experts", 4), ("moe_top_k", 2), ("moe_capacity_factor", 2.0))
DROPOUT = {
    "dp_sp_ring": ((2, 2, 1), AXES, RING),
    "sp_tp_ring": ((1, 2, 2), AXES, RING),
    "dp_tp_ring": ((2, 1, 2), AXES, RING),
    "dp_ep_moe": ((2, 2), ("data", "expert"), MOE),
    "remat_bf16_dp_sp_ring": ((2, 2, 1), AXES, RING + (("remat", "bf16"),)),
}


def _dropout_run(name, seed):
    mesh_shape, axes, extra = DROPOUT[name]
    extra = extra + (("dropout", 0.1),)
    jcfg, params, inp = _model(extra, seed=2)
    inp = dict(inp, toks=_tokens(3, 4, 16), tgt=_tokens(4, 4, 16))
    res = pool().run("case_mesh_loss", inputs=inp, cfg=dict(CFG, **dict(
        extra)), mesh_shape=mesh_shape, mesh_axes=axes, seed=seed)
    return jcfg, params, inp, res


@pytest.mark.parametrize("name", list(DROPOUT))
def test_dropout_sharded_step_is_the_unsharded_step(name):
    """Equal generator seeds on every rank: the sharded loss and every
    synced gradient shard are the port's unsharded step's, which the
    masks do move (its loss differs from the step without dropout)."""
    jcfg, params, inp, res = _dropout_run(name, seed=7)
    plain = float(jtt.lm_loss(params, jnp.asarray(inp["toks"], jnp.int32),
                              jnp.asarray(inp["tgt"], jnp.int32), jcfg))
    for r in res:
        assert abs(r["ref_loss"] - plain) > 1e-3, (r["ref_loss"], plain)
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=TOL)
        _check_grads(r["grads"], lambda n: r["ref_grads"][n])


@pytest.mark.parametrize("name", list(DROPOUT))
def test_dropout_config_without_generator_is_jax(name):
    """The same configs with no generator: JAX's unsharded loss and
    gradients (no key, no dropout)."""
    jcfg, params, inp, res = _dropout_run(name, seed=None)
    loss, g = _jax_loss_grads(params, jcfg, inp["toks"], inp["tgt"])
    tol = REMAT_TOL if jcfg.remat != "none" else TOL
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL)
        _check_grads(r["grads"], lambda n: _jleaf(g, n), tol)


# ---------------------------------------------------------------------------
# a seq axis without ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(1, 4, 1), (2, 2, 1), (1, 2, 2)])
@pytest.mark.parametrize("ragged", [False, True])
def test_seq_axis_without_ring_matches_jax(mesh_shape, ragged):
    """The global sequence gathered over ``seq``: flash attention for a
    packed batch, the plain attention with ragged ``lengths``. JAX's
    ``lm_loss(mesh=)`` on the same mesh is its unsharded loss first."""
    jcfg, params, inp = _model()
    lens = [16, 10, 16, 7] if ragged else None
    inp = dict(inp, toks=_tokens(5, 4, 16), tgt=_tokens(6, 4, 16))
    if ragged:
        inp["lens"] = np.asarray(lens, np.int64)
    loss, g = _jax_loss_grads(params, jcfg, inp["toks"], inp["tgt"], lens)
    jmesh = jplace.make_mesh(mesh_shape, AXES)
    jl = jtt.lm_loss(params, jnp.asarray(inp["toks"], jnp.int32),
                     jnp.asarray(inp["tgt"], jnp.int32), jcfg, mesh=jmesh,
                     lengths=None if lens is None else
                     jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(float(jl), float(loss), rtol=TOL)
    res = pool().run("case_mesh_loss", inputs=inp, cfg=CFG,
                     mesh_shape=mesh_shape, mesh_axes=AXES,
                     use_lengths=ragged)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL)
        _check_grads(r["grads"], lambda n: _jleaf(g, n))


# ---------------------------------------------------------------------------
# prefill and prefill_into_slot
# ---------------------------------------------------------------------------

PREFILL = {
    "dp_sp_ring": ((2, 2, 1), AXES, RING, "shard"),
    "sp_no_ring_gqa_rope": ((1, 4, 1), AXES, (("n_kv_heads", 2),
                                              ("use_rope", True)), "dtensor"),
    "dp_tp": ((2, 1, 2), AXES, (), "whole"),
    "dp_ep_moe": ((2, 2), ("data", "expert"), MOE, "dtensor"),
}


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_mesh_matches_jax(name):
    """Last-position logits and the whole arena on every rank, within
    ATOL of JAX's ``prefill`` unsharded and under a JAX mesh of the same
    shape (itself within ATOL of unsharded); the ranks agree bitwise."""
    mesh_shape, axes, extra, store = PREFILL[name]
    jcfg, params, inp = _model(extra)
    toks = _tokens(7, 4, 16)
    want, wcache = jtt.prefill(params, jnp.asarray(toks, jnp.int32), jcfg,
                               24)
    jm, jmcache = jtt.prefill(params, jnp.asarray(toks, jnp.int32), jcfg,
                              24, mesh=jplace.make_mesh(mesh_shape, axes))
    _close(jm, want, "jax mesh logits")
    for n in ("k", "v"):
        _close(jmcache[n], wcache[n], f"jax mesh {n}")
    res = pool().run("case_mesh_serve", inputs=dict(inp, toks=toks),
                     cfg=dict(CFG, **dict(extra)), mesh_shape=mesh_shape,
                     mesh_axes=axes, what="prefill", store=store,
                     cache_len=24)
    _same_on_every_rank(res, "logits", "k", "v")
    for ref, cache in ((want, wcache), (jm, jmcache)):
        _close(res[0]["logits"], ref, "logits")
        for n in ("k", "v"):
            _close(res[0][n], cache[n], n)


@pytest.mark.parametrize("mesh_shape,extra", [((1, 2, 2), RING),
                                              ((1, 4, 1), ())])
def test_prefill_into_slot_mesh_matches_jax(mesh_shape, extra):
    """A [1, 16] prompt right-padded from length 11 into row 1 of a
    3-row arena: logits and arena within ATOL of JAX's unsharded and
    mesh calls; the other rows, and row 1 past the bucket, keep their
    bytes."""
    jcfg, params, inp = _model(extra)
    toks = _tokens(8, 1, 16)
    rng = np.random.RandomState(9)
    shape = (CFG["n_layers"], 3, 24, jcfg.kv_heads, jcfg.head_dim)
    arena = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    jargs = (jnp.asarray(toks, jnp.int32), jnp.int32(11), jnp.int32(1),
             jcfg)
    jarena = {n: jnp.asarray(a) for n, a in arena.items()}
    want, wcache = jtt.prefill_into_slot(params, jarena, *jargs)
    jm, jmcache = jtt.prefill_into_slot(
        params, jarena, *jargs, mesh=jplace.make_mesh(mesh_shape, AXES))
    _close(jm, want, "jax mesh logits")
    for n in ("k", "v"):
        _close(jmcache[n], wcache[n], f"jax mesh {n}")
    res = pool().run("case_mesh_serve", inputs=dict(inp, toks=toks, **arena),
                     cfg=dict(CFG, **dict(extra)), mesh_shape=mesh_shape,
                     mesh_axes=AXES, what="slot", length=11, slot=1)
    _same_on_every_rank(res, "logits", "k", "v")
    r = res[0]
    for ref, cache in ((want, wcache), (jm, jmcache)):
        _close(r["logits"], ref, "logits")
        for n in ("k", "v"):
            _close(r[n], cache[n], n)
    for n in ("k", "v"):
        np.testing.assert_array_equal(r[n][:, [0, 2]], arena[n][:, [0, 2]])
        np.testing.assert_array_equal(r[n][:, 1, 16:], arena[n][:, 1, 16:])


# ---------------------------------------------------------------------------
# generate and beam_search
# ---------------------------------------------------------------------------

GEN_MESHES = {"dp_tp": (2, 1, 2), "sp_tp": (1, 2, 2)}
GEN_MODES = {"greedy": dict(temperature=0.0),
             "sampled": dict(temperature=0.8, key=3),
             "int8_greedy": dict(temperature=0.0, int8=True)}


@functools.lru_cache(maxsize=None)
def _jax_generate(mode, max_new=6):
    kw = dict(GEN_MODES[mode])
    jcfg, params, inp = _model(int8=kw.pop("int8", False))
    prompt = _tokens(10, 2, 8)
    jkw = {"temperature": kw["temperature"]}
    if "key" in kw:
        jkw["key"] = jax.random.PRNGKey(kw["key"])
    ids = jtt.generate(params, jnp.asarray(prompt, jnp.int32), jcfg,
                       max_new=max_new, **jkw)
    return inp, prompt, np.asarray(ids), kw


@pytest.mark.parametrize("mesh", list(GEN_MESHES))
@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_generate_mesh_ids_are_jax(mesh, mode):
    """Greedy, sampled at 0.8 under ``prng_key(3)``, and the int8 tree
    (dequantized whole for the mesh prefill): JAX's unsharded ids
    exactly, the same on every rank."""
    inp, prompt, want, kw = _jax_generate(mode)
    res = pool().run("case_mesh_serve", inputs=dict(inp, toks=prompt),
                     cfg=CFG, mesh_shape=GEN_MESHES[mesh], mesh_axes=AXES,
                     what="generate", max_new=6,
                     store="int8" if mode.startswith("int8") else "shard",
                     **kw)
    for r in res:
        np.testing.assert_array_equal(r["ids"], want)


@pytest.mark.parametrize("mesh", list(GEN_MESHES))
def test_beam_search_mesh_is_jax(mesh):
    """B = 2, K = 4: JAX's tokens exactly, scores within 1e-4, on every
    rank."""
    jcfg, params, inp = _model()
    prompt = _tokens(11, 2, 8)
    wt, ws = jtt.beam_search(params, jnp.asarray(prompt, jnp.int32), jcfg,
                             max_new=5, beam_size=4)
    res = pool().run("case_mesh_serve", inputs=dict(inp, toks=prompt),
                     cfg=CFG, mesh_shape=GEN_MESHES[mesh], mesh_axes=AXES,
                     what="beam", max_new=5, beam=4)
    _same_on_every_rank(res, "ids", "scores")
    np.testing.assert_array_equal(res[0]["ids"], np.asarray(wt))
    _close(res[0]["scores"], ws, "scores")


def test_generate_decodes_on_the_tree_gathered_once():
    """ROADMAP C16: ``generate(mesh=)`` gathers the tree whole once a
    call and decodes unsharded, where the JAX decode runs partitioned
    under GSPMD. From DTensors over (data 2, model 2): 2 and 6 new
    tokens issue the same collectives, which are the mesh prefill's plus
    one "param" gather per model-sharded leaf (embed, qkv, attn_out,
    mlp_in, mlp_out); the ids are JAX's."""
    inp, prompt, want, _ = _jax_generate("greedy")
    kw = dict(inputs=dict(inp, toks=prompt), cfg=CFG,
              mesh_shape=GEN_MESHES["dp_tp"], mesh_axes=AXES,
              store="dtensor")
    pre = pool().run("case_mesh_serve", what="prefill", cache_len=14, **kw)
    short = pool().run("case_mesh_serve", what="generate", max_new=2, **kw)
    long = pool().run("case_mesh_serve", what="generate", max_new=6, **kw)
    for p, s, lg in zip(pre, short, long):
        assert s["collectives"] == lg["collectives"]
        params = [c for c in s["collectives"] if c[2] == "param"]
        assert params == [("all_gather", "model", "param")] * 5, params
        rest = [c for c in s["collectives"] if c[2] != "param"]
        assert rest == p["collectives"]
        np.testing.assert_array_equal(lg["ids"], want)


# ---------------------------------------------------------------------------
# the refusals that stay
# ---------------------------------------------------------------------------

def _jax_raises(call):
    with pytest.raises(ValueError):
        call()


REFUSALS = ["forward_int8", "slot_batch_axis", "prefill_batch",
            "seq_no_ring_length"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_that_stay(case):
    """The int8 tree in the mesh forward (the JAX forward takes none);
    a [1, Tb] slot prompt over a batch axis of 2, a batch of 3 over it,
    and 15 positions over a ``seq`` axis of 4 without ring attention:
    ``ValueError`` on every rank, as the JAX function raises."""
    if case == "forward_int8":
        _, _, inp = _model(int8=True)
        kw = dict(inputs=dict(inp, toks=_tokens(12, 2, 8)),
                  mesh_shape=(2, 1, 2), what="forward", store="int8")
        match = "float parameter tree"
    else:
        jcfg, params, inp = _model()
        shape, B, T, what = {
            "slot_batch_axis": ((2, 2, 1), 1, 16, "slot"),
            "prefill_batch": ((2, 2, 1), 3, 16, "prefill"),
            "seq_no_ring_length": ((1, 4, 1), 2, 15, "prefill"),
        }[case]
        toks = _tokens(13, B, T)
        jmesh = jplace.make_mesh(shape, AXES)
        if what == "slot":
            arena = {n: np.zeros((CFG["n_layers"], 2, 24, jcfg.kv_heads,
                                  jcfg.head_dim), np.float32)
                     for n in ("k", "v")}
            _jax_raises(lambda: jtt.prefill_into_slot(
                params, {n: jnp.asarray(a) for n, a in arena.items()},
                jnp.asarray(toks, jnp.int32), jnp.int32(11), jnp.int32(0),
                jcfg, mesh=jmesh))
            inp = dict(inp, **arena)
        else:
            _jax_raises(lambda: jtt.prefill(
                params, jnp.asarray(toks, jnp.int32), jcfg, 24, mesh=jmesh))
        kw = dict(inputs=dict(inp, toks=toks), mesh_shape=shape, what=what,
                  length=11, slot=0)
        match = f"tokens [{B}, {T}] do not split"
    res = pool().run("case_mesh_serve", cfg=CFG, mesh_axes=AXES, **kw)
    for r in res:
        assert match in r.get("error", ""), r
