"""The port's multi-process runtime against ``paddle_tpu``'s on the CPU:
``distributed.init`` over the launcher's env contract (gloo with
``PADDLE_PLATFORM=cpu``, NCCL otherwise, no fallback), ranks that never
import JAX, hybrid ``dcn`` meshes, barriers, a lost rank failing instead
of hanging, and a transformer train step over a hybrid mesh.

The references are ``tests/test_distributed.py``'s
``TestMultiProcessCluster``, ``TestHybridMeshSingleProcess`` and
``TestMultiProcessTransformer``. The JAX package runs 2 processes of 4
virtual devices there; a port rank drives one device, so its cases run
on the 4-rank pool (``tests/torch_dist_util.pool``) or on 2 processes
started by ``runtime/launch.launch_local``."""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.models import transformer as jtt
from tests.torch_dist_util import REPO, RankError, pool


def test_ranks_join_gloo_and_never_import_jax():
    for r, env in enumerate(pool().run("case_env")):
        assert env == {"rank": r, "count": 4, "backend": "gloo",
                       "devices": 4, "jax": False, "paddle_tpu": False,
                       "threads": 1}


def test_collectives_on_a_mesh():
    out = pool().run("case_collectives")
    x = [np.arange(4, dtype=np.float32) + 10 * r for r in range(4)]
    for r, o in enumerate(out):
        d, m = divmod(r, 2)
        np.testing.assert_array_equal(o["sum"], sum(x))
        np.testing.assert_array_equal(o["gather"],
                                      np.stack([x[2 * d], x[2 * d + 1]]))
        np.testing.assert_array_equal(o["rs"],
                                      (x[m] + x[m + 2])[2 * d:2 * d + 2])
        np.testing.assert_array_equal(o["pp"], x[(r + 2) % 4])
        assert o["kinds"] == ["all_reduce", "all_reduce", "all_gather",
                              "reduce_scatter", "all_to_all", "ppermute"]


class TestHybridMesh:
    """``TestHybridMeshSingleProcess`` and the hybrid psum of
    ``TestMultiProcessCluster`` on the 4-rank pool."""

    @pytest.fixture(scope="class")
    def got(self):
        return pool().run("case_hybrid")

    def test_single_slice_falls_back_to_plain_mesh(self, got):
        assert got[0]["single"] == {"data": 2, "model": 2}

    def test_shape_mismatch_raises(self, got):
        assert "devices" in got[0]["mismatch"]

    def test_dcn_axis_psum_sees_every_device(self, got):
        for g in got:
            assert g["hybrid"] == {"dcn": 2, "data": 2}
            assert g["total"] == 4.0
            assert g["barrier_s"] >= 0.0


CLUSTER_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import compat, spmd
    distributed.init()
    assert distributed.backend() == "gloo"
    mesh = distributed.hybrid_mesh((1,), ("data",))
    assert place.mesh_shape(mesh) == {{"dcn": 2, "data": 1}}

    def f(x):
        return spmd.all_reduce(x.sum(), compat.current_mesh(),
                               ("dcn", "data"))
    total = compat.shard_map(f, mesh=mesh,
                             in_specs=spmd.P(("dcn", "data")),
                             out_specs=spmd.P())(torch.ones(2))
    assert float(total) == 2.0, float(total)
    rank = distributed.process_index()
    with open(os.path.join(os.environ["TEST_OUT_DIR"], f"ok_{{rank}}"),
              "w") as fh:
        fh.write(f"{{float(total)}} {{distributed.process_count()}} "
                 f"{{'jax' in sys.modules}}")
    distributed.shutdown()
""")


class TestMultiProcessCluster:
    def test_two_process_psum(self, tmp_path):
        """2 processes started by the launcher join one gloo group; a
        dcn x data mesh spans them and a global sum sees both."""
        from paddle_tpu_torch.runtime import launch
        worker = tmp_path / "worker.py"
        worker.write_text(CLUSTER_WORKER.format(repo=REPO))
        rcs = launch.launch_local(
            2, [str(worker)], env_extra={"TEST_OUT_DIR": str(tmp_path),
                                         "PADDLE_DIST_TIMEOUT_S": "60"},
            timeout=120)
        assert rcs == [0, 0], rcs
        for rank in range(2):
            assert (tmp_path / f"ok_{rank}").read_text() == "2.0 2 False"


class TestMultiProcessTransformer:
    def test_hybrid_mesh_transformer_train_step(self):
        """Two SGD steps of a transformer LM (ring-attention CP over seq,
        DP over dcn x data) on the hybrid mesh: the same losses on every
        rank, the first equal to the JAX package's single-device loss,
        the second to its loss after one step of the same update."""
        cfg = dict(vocab=64, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                   max_len=16)
        jcfg = jtt.TransformerConfig(**cfg, dtype=jnp.float32)
        params = jtt.init_params(jax.random.PRNGKey(0), jcfg)
        rng = np.random.RandomState(0)
        toks = rng.randint(0, 64, (8, 16)).astype(np.int32)
        tgt = rng.randint(0, 64, (8, 16)).astype(np.int32)

        def loss(p):
            return jtt.lm_loss(p, jnp.asarray(toks), jnp.asarray(tgt), jcfg)
        l1, g = jax.value_and_grad(loss)(params)
        l2 = loss(jax.tree_util.tree_map(lambda w, gr: w - 0.1 * gr,
                                         params, g))
        inp = {f"p/{k}": np.asarray(v) for k, v in params.items()
               if k != "blocks"}
        inp.update({f"p/blocks/{k}": np.asarray(v)
                    for k, v in params["blocks"].items()})
        inp.update(toks=toks.astype(np.int64), tgt=tgt.astype(np.int64))
        res = pool().run("case_lm", inputs=inp,
                         cfg={**cfg, "use_ring_attention": True},
                         mesh_shape=(1, 2), mesh_axes=("data", "seq"),
                         hybrid=True, steps=2, lr=0.1)
        assert res[0]["mesh"] == {"dcn": 2, "data": 1, "seq": 2}
        assert len({tuple(r["losses"]) for r in res}) == 1
        l1p, l2p = res[0]["losses"]
        np.testing.assert_allclose([l1p, l2p], [float(l1), float(l2)],
                                   rtol=1e-5)
        assert l2p < l1p


def test_lost_rank_fails_the_case_and_the_pool_restarts():
    """A rank that dies mid-collective fails its case at once; the pool
    is torn down and the next case gets a fresh one."""
    with pytest.raises(RankError, match="gave no result|rank"):
        pool().run("case_lost_rank", timeout=60)
    assert pool().run("case_env")[0]["count"] == 4


class TestInit:
    def test_no_env_is_single_process(self, monkeypatch):
        from paddle_tpu_torch import distributed
        for k in ("PADDLE_COORDINATOR", "PADDLE_NUM_PROCESSES",
                  "PADDLE_PROCESS_ID", "PADDLE_PLATFORM"):
            monkeypatch.delenv(k, raising=False)
        distributed.init()
        assert not distributed.is_initialized()
        assert distributed.process_count() == 1
        assert distributed.process_index() == 0
        assert distributed.barrier("solo") >= 0.0

    def test_nccl_without_a_card_raises(self, monkeypatch):
        """No quiet gloo fallback: NCCL is the default, and without a
        card ``init`` refuses unless the CPU is asked for."""
        import torch

        from paddle_tpu_torch import distributed
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        monkeypatch.delenv("PADDLE_PLATFORM", raising=False)
        with pytest.raises(RuntimeError, match="PADDLE_PLATFORM=cpu"):
            distributed.init("127.0.0.1:1", 1, 0)
        assert not distributed.is_initialized()

    def test_pending_names_are_gone(self):
        import paddle_tpu_torch as T
        assert T._PENDING == {}
        assert T.distributed.__name__ == "paddle_tpu_torch.distributed"
