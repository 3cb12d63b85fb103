"""The port's SPMD trainer tier against ``paddle_tpu`` on the CPU:
``SGD(parallel=...)`` data and tensor parallelism, the sharded
embedding, ZeRO stages 0-3 (policy, numerics with and without gradient
accumulation, resident bytes, step records, the collective pattern),
checkpoint resharding, the sharded CTR tables and the ``@@i`` sharded
checkpoint layout across packages.

The references are ``tests/test_parallel.py``, ``tests/test_zero.py``,
``tests/test_ctr.py::test_sharded_matches_single_device`` and
``tests/test_checkpoint_async.py::TestShardedLayout``. The port trains on
4 gloo ranks (``tests/torch_dist_util.pool``) from the JAX package's
initial parameters; the JAX trainer runs here on a mesh of the same
shape (4 of the 8 virtual CPU devices). Costs per step within 1e-5
relative of the JAX trajectory, final parameters within 1e-5 of their
max."""

import os
import shutil

import jax
import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu import parallel as jpar
from paddle_tpu.core import place as jplace
from paddle_tpu.utils.rng import KeySource
from tests import torch_dist_cases as cases
from tests.torch_dist_util import pool

RTOL = 1e-5


def _rows(net):
    rng = np.random.RandomState(0)
    if net == "convbn":
        x = rng.randn(32, 32).astype(np.float32)
        y = rng.randint(3, size=32).astype(np.int64)
        return {"x": x, "y": y}, [(x[i], int(y[i])) for i in range(32)]
    if net == "q8":
        x = rng.rand(8, 512).astype(np.float32)
        y = rng.randint(0, 5, 8).astype(np.int64)
        return {"x": x, "y": y}, [(x[i], int(y[i])) for i in range(8)]
    if net in ("mlp", "bn"):
        x = rng.randn(32, 8).astype(np.float32)
        y = rng.randint(3, size=32).astype(np.int64)
        return {"x": x, "y": y}, [(x[i], int(y[i])) for i in range(32)]
    if net == "emb":
        rng = np.random.RandomState(1)
        w = np.stack([rng.randint(0, 40, 5) for _ in range(16)])
        y = np.arange(16) % 2
        return ({"words": w.astype(np.int64), "y": y.astype(np.int64)},
                [([int(v) for v in w[i]], int(y[i])) for i in range(16)])
    return {}, list(J.models.ctr.synthetic_reader(1024, 256, n=256)())


_JAX = {}


def jax_train(net="mlp", opt="momentum", mesh_shape=(4,),
              mesh_axes=("data",), zero=0, accum=1, passes=2, batch=16,
              rules=(), seed=11):
    """The JAX trainer's costs, trainer and initial params (cached)."""
    key = (net, opt, mesh_shape, mesh_axes, zero, accum, passes, batch,
           tuple(rules), seed)
    if key in _JAX:
        return _JAX[key]
    cost = cases.NETS[net](J)
    params = J.parameters.create(cost, KeySource(seed))
    init = None
    cfg = None
    if mesh_shape is not None:
        mesh = jplace.make_mesh(mesh_shape, mesh_axes)
        jrules = []
        for kind, pattern in rules:
            jrules += (J.models.ctr.ctr_dist_rules() if kind == "ctr"
                       else [getattr(jpar, kind)(pattern)])
        cfg = jpar.DistConfig(mesh, param_rules=jrules, zero_stage=zero)
    tr = J.trainer.SGD(cost=cost, parameters=params,
                       update_equation=cases.optimizer(J, opt),
                       parallel=cfg, grad_accum_steps=accum)
    costs = []
    _, rows = _rows(net)
    tr.train(reader=J.batch(lambda: iter(rows), batch), num_passes=passes,
             event_handler=lambda e: costs.append(e.cost) if isinstance(
                 e, J.event.EndIteration) else None)
    _JAX[key] = (np.asarray(costs), tr, init)
    return _JAX[key]


def jax_init(net, seed):
    """The JAX package's initial parameters, as the port's inputs."""
    key = ("init", net, seed)
    if key not in _JAX:
        params = J.parameters.create(cases.NETS[net](J), KeySource(seed))
        _JAX[key] = {f"p/{k}": np.asarray(v)
                     for k, v in params.values.items()}
    return _JAX[key]


def port_train(net="mlp", seed=11, **kw):
    init = jax_init(net, seed)
    inputs, _ = _rows(net)
    return pool().run("case_train", inputs={**inputs, **init}, net=net,
                      **kw)


def _traj(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _final(res, jtr):
    for k, v in jtr.parameters.values.items():
        w = np.asarray(v)
        np.testing.assert_allclose(res["final"][k], w, rtol=0,
                                   atol=RTOL * max(1.0, np.abs(w).max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------

def test_dp_matches_single_device():
    """DP over 4 ranks against the JAX DP trainer on 4 devices (and the
    JAX single-device run, as the reference test holds it)."""
    want, jtr, _ = jax_train("mlp", mesh_shape=(4,))
    single, _, _ = jax_train("mlp", mesh_shape=None)
    out = port_train("mlp", mesh_shape=(4,), mesh_axes=("data",))
    for r in out:
        _traj(r["costs"], want)
        assert r["specs"]["h.w"] == ()               # replicated
    np.testing.assert_allclose(out[0]["costs"], single, rtol=2e-4,
                               atol=1e-5)
    _final(out[0], jtr)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_ragged_last_batch_raises(accum):
    """30 rows in batches of 8 without drop_last: the last batch's 6 rows
    do not divide over 4 ranks. The JAX trainer trains 3 steps and its
    ``device_put`` raises ValueError on the fourth; every port rank does
    the same after the same 3 costs (no rank waits in a collective).
    Under grad accumulation the 8-row batches' 4-row microbatches divide
    and the 6-row batch is refused whole, before its microbatches."""
    inputs, rows = _rows("mlp")
    inputs = {k: v[:30] for k, v in inputs.items()}
    cost = cases.NETS["mlp"](J)
    jtr = J.trainer.SGD(
        cost=cost, parameters=J.parameters.create(cost, KeySource(11)),
        update_equation=cases.optimizer(J, "momentum"),
        parallel=jpar.DistConfig(jplace.make_mesh((4,), ("data",))),
        grad_accum_steps=accum)
    want = []
    with pytest.raises(ValueError, match="divisible by 4"):
        jtr.train(reader=J.batch(lambda: iter(rows[:30]), 8,
                                 drop_last=False), num_passes=1,
                  event_handler=lambda e: want.append(e.cost)
                  if isinstance(e, J.event.EndIteration) else None)
    assert len(want) == 3
    out = pool().run("case_train", inputs={**inputs, **jax_init("mlp", 11)},
                     net="mlp", mesh_shape=(4,), mesh_axes=("data",),
                     batch=8, passes=1, accum=accum, drop_last=False)
    for r in out:
        assert "6 rows does not divide" in r["error"], r
        _traj(r["costs"], want)


def test_tp_fc_column_sharding():
    rules = (("fc_column_rule", r"^h\.w$"),)
    want, jtr, _ = jax_train("mlp", mesh_shape=(2, 2),
                             mesh_axes=("data", "model"), rules=rules)
    out = port_train("mlp", mesh_shape=(2, 2), mesh_axes=("data", "model"),
                     rules=rules)
    for r in out:
        _traj(r["costs"], want)
        assert r["specs"]["h.w"] == (None, "model")
        assert r["local_shapes"]["h.w"] == (8, 8)
    assert tuple(jtr.parameters.values["h.w"].sharding.spec) == \
        (None, "model")
    _final(out[0], jtr)


def test_sharded_embedding_training():
    rules = (("embedding_vocab_rule", r"^emb\.w$"),)
    kw = dict(mesh_shape=(2, 2), mesh_axes=("data", "model"), rules=rules,
              opt="adam2", passes=3, batch=8)
    want, jtr, _ = jax_train("emb", seed=3, **kw)
    out = port_train("emb", seed=3, **kw)
    for r in out:
        _traj(r["costs"], want)
        assert r["specs"]["emb.w"][0] == "model"
    assert want[-1] < want[0]
    _final(out[0], jtr)


def test_ctr_sharded_matches_single_device():
    """``tests/test_ctr.py::test_sharded_matches_single_device``: the
    vocab-sharded embedding and the row-sharded wide weight over
    ``model`` (``ctr_dist_rules``)."""
    kw = dict(mesh_shape=(2, 2), mesh_axes=("data", "model"),
              rules=(("ctr", ""),), opt="adam2", passes=2, batch=32)
    want, jtr, _ = jax_train("ctr", seed=5, **kw)
    out = port_train("ctr", seed=5, **kw)
    for r in out:
        _traj(r["costs"], want)
        assert r["specs"]["ctr_emb.w"][0] == "model"
        assert r["specs"]["ctr_out.w0"][0] == "model"
    _final(out[0], jtr)


@pytest.mark.parametrize("net", ["bn", "convbn"])
def test_dp_batch_norm_over_the_global_batch(net):
    """Batch norm under DP normalizes over the global batch, as the JAX
    package's GSPMD step does: the port over 4 ranks follows the JAX DP
    trajectory, and its running statistics equal the JAX trainer's."""
    want, jtr, _ = jax_train(net, opt="momentum", mesh_shape=(4,))
    out = port_train(net, opt="momentum", mesh_shape=(4,))
    for r in out:
        _traj(r["costs"], want)
        for k, v in jtr.parameters.state.items():
            w = np.asarray(v)
            np.testing.assert_allclose(r["state"][k], w, rtol=0,
                                       atol=RTOL * max(1.0, np.abs(w).max()),
                                       err_msg=k)
    _final(out[0], jtr)


def test_q8_dp_sharding_invariance():
    """``tests/test_q8.py::test_dp_sharding_invariance``: the q8 blocks'
    batch statistics and stash absmax reduce over the ranks, so data
    parallelism over 4 ranks follows the JAX package's DP trajectory
    and its delayed-scaling state (3 Momentum steps of batch 8). Stash
    codes after a convolution may flip by one step between libraries
    (``tests/torch_q8_util.py``): losses and state within 1e-4, the
    tolerance of the q8 graph tests."""
    kw = dict(opt="momentum05", passes=3, batch=8, mesh_shape=(4,))
    want, jtr, _ = jax_train("q8", seed=7, **kw)
    out = port_train("q8", seed=7, **kw)
    for r in out:
        np.testing.assert_allclose(r["costs"], want, rtol=1e-4)
        for k in ("q8t_1.q_scale", "q8t_add.q_scale", "q8t_entry.q_mean"):
            w = np.asarray(jtr.parameters.state[k])
            np.testing.assert_allclose(r["state"][k], w, rtol=0,
                                       atol=1e-4 * max(1.0, np.abs(w).max()),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_zero.py
# ---------------------------------------------------------------------------

class TestZeroPolicy:
    """The policy against the JAX DistConfig's on the same mesh shape."""

    @pytest.fixture(scope="class")
    def got(self):
        return pool().run("case_zero_policy")[0]

    def _j(self, zero=1, shape=(4,), axes=("data",), **kw):
        return jpar.DistConfig(jplace.make_mesh(shape, axes),
                               zero_stage=zero, **kw)

    def test_largest_divisible_dim_wins(self, got):
        cfg = self._j()
        for key, args in (("w816", ("w", (8, 16))), ("w168", ("w", (16, 8))),
                          ("b16", ("b", (16,)))):
            assert got[key] == tuple(cfg.zero_spec(*args)), key
        assert got["w816"] == (None, "data")

    def test_indivisible_and_scalar_stay_replicated(self, got):
        assert got["b3"] == () == tuple(self._j().zero_spec("b", (3,)))
        assert got["c"] == ()

    def test_tiny_leaves_stay_replicated(self, got):
        cfg = self._j(zero_min_size=64)
        assert got["tiny"] == tuple(cfg.zero_spec("b", (16,))) == ()
        assert got["tiny_w"] == tuple(cfg.zero_spec("w", (8, 16)))

    def test_zero0_is_all_replicated(self, got):
        assert got["z0"] == tuple(self._j(0).zero_spec("w", (8, 16))) == ()

    def test_tp_matched_params_keep_their_layout(self, got):
        cfg = self._j(1, (2, 2), ("data", "model"),
                      param_rules=[jpar.fc_column_rule(r"^h\.w$")])
        assert got["tp"] == tuple(cfg.zero_spec("h.w", (8, 16)))
        assert got["tp_state"] == (None, "model")
        assert got["placements"] == [("Replicate", None), ("Shard", 1)]

    def test_report_names_every_replicated_leaf(self, got):
        vals = {"h.w": np.zeros((8, 16), np.float32),
                "o.b": np.zeros((3,), np.float32),
                "s": np.zeros((), np.float32)}
        want = self._j().zero_report(vals)
        assert got["report"]["sharded"] == want["sharded"]
        assert got["report"]["replicated"] == want["replicated"]
        assert got["report"]["axis_size"] == 4

    def test_grad_spec_stages(self, got):
        for stage in (0, 1, 2, 3):
            cfg = self._j(stage)
            assert got[f"grad{stage}"] == (
                tuple(cfg.grad_spec("w", (8, 16))),
                tuple(cfg.grad_spec("w", (8, 16), accum=True))), stage

    def test_store_spec_stages(self, got):
        for stage in (0, 1, 2, 3):
            assert got[f"store{stage}"] == tuple(
                self._j(stage).store_spec("w", (8, 16))), stage

    def test_stage3_tp_matched_params_keep_their_layout(self, got):
        cfg = self._j(3, (2, 2), ("data", "model"),
                      param_rules=[jpar.fc_column_rule(r"^h\.w$")])
        assert got["tp3_store"] == tuple(cfg.store_spec("h.w", (8, 16)))

    def test_report_grad_and_param_sections(self, got):
        vals = {"h.w": np.zeros((8, 16), np.float32),
                "o.b": np.zeros((3,), np.float32),
                "s": np.zeros((), np.float32)}
        for stage in (0, 1, 2, 3):
            rep = self._j(stage).zero_report(vals)
            for sec in ("grads", "params"):
                g = got[f"rep{stage}"][sec]
                assert g["sharded"] == sorted(rep[sec]["sharded"])
                assert g["replicated"] == rep[sec]["replicated"]


OPTS = ("sgd", "momentum", "adam")


class TestZeroNumerics:
    """Every stage is a pure layout change: the port at each stage
    follows the JAX trajectory (zero=0 on the same 4-device mesh, 20
    steps), with and without gradient accumulation."""

    @pytest.mark.parametrize("stage", [0, 1, 2, 3])
    @pytest.mark.parametrize("opt", OPTS)
    def test_trajectory_matches_jax(self, stage, opt):
        want, jtr, _ = jax_train("mlp", opt=opt, passes=10)
        out = port_train("mlp", opt=opt, passes=10, zero=stage)
        assert len(want) == 20
        for r in out:
            _traj(r["costs"], want)
        _final(out[0], jtr)

    @pytest.mark.parametrize("stage", [1, 2, 3])
    @pytest.mark.parametrize("opt", ["momentum", "adam"])
    def test_trajectory_matches_with_grad_accum(self, stage, opt):
        want, _, _ = jax_train("mlp", opt=opt, passes=10, accum=2)
        out = port_train("mlp", opt=opt, passes=10, accum=2, zero=stage)
        for r in out:
            _traj(r["costs"], want)

    def test_same_stage_jax_trajectory(self):
        """Stage 3 against the JAX trainer at stage 3 too."""
        want, _, _ = jax_train("mlp", opt="adam", passes=10, zero=3)
        out = port_train("mlp", opt="adam", passes=10, zero=3)
        _traj(out[0]["costs"], want)

    def test_opt_state_sharded_and_bytes_quartered(self):
        b = {}
        for stage in (0, 1):
            _, jtr, _ = jax_train("mlp", opt="adam", passes=1, zero=stage)
            out = port_train("mlp", opt="adam", passes=1, zero=stage)
            b[stage] = out[0]["opt_bytes"]
            assert b[stage] == jtr.opt_state_bytes_per_device(), stage
        r1 = out[0]
        assert r1["opt_specs"]["h.w"][0] == (None, "data")
        assert b[1] <= b[0] / 4 + 2 * 3 * 4
        assert set(r1["report"]["replicated"]) == {"o.b"}

    def test_stage3_param_and_grad_bytes_quartered(self):
        got = {}
        for stage in (0, 2, 3):
            _, jtr, _ = jax_train("mlp", opt="adam", passes=1, zero=stage)
            r = port_train("mlp", opt="adam", passes=1, zero=stage)[0]
            got[stage] = r
            assert r["grad_bytes"] == jtr.grad_bytes_per_device(), stage
            assert r["param_bytes"] == jtr.param_bytes_per_device(), stage
            assert r["opt_bytes"] == jtr.opt_state_bytes_per_device(), stage
        slack = 3 * 4
        t0, t2, t3 = got[0], got[2], got[3]
        assert t0["grad_bytes"] == t0["param_bytes"]
        assert t2["grad_bytes"] <= t0["grad_bytes"] / 4 + slack
        assert t2["param_bytes"] == t0["param_bytes"]
        assert t3["param_bytes"] <= t0["param_bytes"] / 4 + slack
        assert t3["specs"]["h.w"] == (None, "data")

    def test_stage1_accum_carry_counts_sharded_grad_bytes(self):
        _, j1a, _ = jax_train("mlp", opt="sgd", passes=1, zero=1, accum=2)
        p = port_train("mlp", opt="sgd", passes=1, zero=1)[0]
        a = port_train("mlp", opt="sgd", passes=1, zero=1, accum=2)[0]
        assert p["grad_bytes"] == p["param_bytes"]
        assert a["grad_bytes"] <= p["grad_bytes"] / 4 + 3 * 4
        assert a["grad_bytes"] == j1a.grad_bytes_per_device()

    def test_step_records_carry_bytes(self, tmp_path):
        from paddle_tpu_torch import observe
        mpath = str(tmp_path / "m.jsonl")
        r = port_train("mlp", opt="adam", passes=1, zero=3,
                       metrics_path=mpath)[0]
        recs = [x for x in observe.read_jsonl(mpath)
                if x.get("kind") == "step"]
        assert len(recs) == 2
        for x in recs:
            assert x["opt_state_bytes"] == r["opt_bytes"]
            assert x["grad_bytes"] == r["grad_bytes"]
            assert x["param_bytes"] == r["param_bytes"]


class TestZeroCollectivePattern:
    """The collective pattern each stage promises
    (``paddle_tpu/parallel/spmd.py:16-45``), read from the record of the
    collectives the port issued (``spmd.record_collectives``)."""

    def _ev(self, stage, accum=1):
        r = port_train("mlp", opt="adam", passes=1, zero=stage,
                       accum=accum, record=True)[0]
        return r["evidence"]

    def test_zero0_has_full_grad_all_reduce(self):
        ev = self._ev(0)
        assert ev["full_grad_all_reduce"] > 0 and ev["reduce_scatter"] == 0

    def test_zero1_reduce_scatters_and_gathers(self):
        ev = self._ev(1, accum=2)
        assert ev["reduce_scatter"] > 0
        assert ev["output_all_gather"] > 0
        assert ev["full_grad_all_reduce"] == 0

    def test_zero2_no_full_grad_all_reduce_anywhere(self):
        for accum in (1, 2):
            ev = self._ev(2, accum)
            assert ev["full_grad_all_reduce"] == 0, \
                ev["full_grad_all_reduce_lines"]
            assert ev["reduce_scatter"] > 0

    def test_zero3_sharded_resident_params_gather_on_use(self):
        ev = self._ev(3)
        assert ev["resident_full_args"] == 0
        assert ev["on_use_all_gather"] > 0
        assert ev["output_all_gather"] == 0
        assert ev["full_grad_all_reduce"] == 0

    def test_zero0_has_full_resident_params(self):
        assert self._ev(0)["resident_full_args"] > 0


class TestZeroCheckpointResharding:
    """Save under one layout, restore under another: the shards merge
    into whole arrays at load, so a restore onto a smaller ZeRO axis or
    another stage is the reshard."""

    def _run(self, zero, shape, axes, passes, ckdir):
        return port_train("mlp", opt="adam", passes=passes, zero=zero,
                          mesh_shape=shape, mesh_axes=axes, ckdir=ckdir)

    @pytest.mark.parametrize("stage", [1, 3])
    def test_resharding_restore_trajectories(self, tmp_path, stage):
        from paddle_tpu_torch.io import checkpoint as ck
        ref = self._run(stage, (4,), ("data",), 6, None)[0]["costs"]
        want, _, _ = jax_train("mlp", opt="adam", passes=6, zero=stage)
        _traj(ref, want)
        ckdir = str(tmp_path / "ck")
        first = self._run(stage, (4,), ("data",), 3, ckdir)[0]["costs"]
        np.testing.assert_array_equal(ref[:6], first)
        latest = ck.latest_checkpoint(ckdir)
        assert ck.checkpoint_meta(latest) == {
            "zero": {"zero_stage": stage, "axis": "data", "axis_size": 4}}
        assert "manifest.p3.json" in os.listdir(latest)
        for name, (z, shape, axes) in {
                "same": (stage, (4,), ("data",)),
                "half": (stage, (2, 2), ("data", "model")),
                "z0": (0, (4,), ("data",))}.items():
            d = str(tmp_path / name)
            shutil.copytree(ckdir, d)
            cont = self._run(z, shape, axes, 3, d)[0]
            if name == "same":
                np.testing.assert_array_equal(ref[6:], cont["costs"])
            else:
                np.testing.assert_allclose(ref[6:], cont["costs"],
                                           rtol=RTOL)
            if name == "z0":
                assert cont["specs"]["h.w"] == ()


# ---------------------------------------------------------------------------
# tests/test_checkpoint_async.py::TestShardedLayout, across packages
# ---------------------------------------------------------------------------

class TestShardedLayout:
    def test_port_sharded_save_loads_in_jax(self, tmp_path):
        from paddle_tpu.io import checkpoint as jck
        x = np.arange(32.0, dtype=np.float32).reshape(4, 8)
        d = str(tmp_path)
        shapes = pool().run("case_save_sharded", inputs={"x": x}, path=d)
        assert shapes == [(1, 8)] * 4
        path = jck.latest_checkpoint(d)
        assert sorted(f for f in os.listdir(path) if f.startswith(
            "params")) == [f"params.p{i}.npz" for i in range(4)]
        step, p, _, _ = jck.load_checkpoint(
            path, {"w": jax.numpy.zeros((4, 8)), "b": jax.numpy.zeros(3)})
        assert step == 3
        np.testing.assert_array_equal(np.asarray(p["w"]), x)
        np.testing.assert_array_equal(np.asarray(p["b"]), np.arange(3.0))

    def test_jax_sharded_save_loads_in_port(self, tmp_path):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from paddle_tpu.io import checkpoint as jck
        mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
        x = np.arange(32.0, dtype=np.float32).reshape(4, 8)
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
        d = str(tmp_path)
        jck.save_checkpoint(d, 3, {"w": xs}, sharded=True)
        for step, w in pool().run("case_load_sharded", path=d):
            assert step == 3
            np.testing.assert_array_equal(w, x)
