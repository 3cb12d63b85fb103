"""The port's parity-tail layers against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_parity_layers.py`` but one: MDLSTM (the op
and the layer with its gradients), row conv, data norm, featmap expand,
the remaining costs, the pos/neg pair evaluator, the decayed-Adagrad
and proximal optimizers' first step, the 3-D transposed conv and the
numeric-gradient cases (here: the port's gradients against
``jax.grad``). ``test_static_pruning_masks_stick`` waits for ROADMAP
A7c, which brings the optimizer's ``StaticPruning`` hook.

Tolerances: fp32 forward 1e-5, gradients through the scans 1e-4 (of
max(1, max|JAX value|)); evaluator counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.ops import sequence as jseq
from paddle_tpu_torch.ops import loss as tloss
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import sequence as tseq
from tests.torch_layers_util import Net, both_values
from tests.torch_ops_util import parity

torch.set_num_threads(1)


def _data(P, name, dim, kind="dense_vector"):
    return P.layer.data(name, getattr(P.data_type, kind)(dim))


class TestMDLSTM:
    def test_mdlstm_matches_jax(self, rng):
        n, H, W, C, D = 2, 3, 4, 5, 6
        args = [rng.randn(n, H, W, C).astype(np.float32)] + [
            (rng.randn(*s) * 0.3).astype(np.float32)
            for s in ((C, 5 * D), (D, 5 * D), (D, 5 * D))]
        parity(jrnn.mdlstm, trnn.mdlstm, args, wrt=(0, 1, 2, 3))

    def test_mdlstm_layer_and_grad(self, rng):
        def b(P):
            L = P.layer
            lo = L.mdlstmemory(_data(P, "mdin", 48), size=5, shape=(3, 4, 4),
                               name="md0")
            fcn = L.fc(lo, 80, act=None, name="md_fc")
            return L.square_error_cost(fcn, _data(P, "mdlbl", 80),
                                       name="md_cost")
        j, t = Net(b, seed=0).check(*both_values({
            "mdin": rng.randn(2, 48).astype(np.float32),
            "mdlbl": rng.randn(2, 80).astype(np.float32)}),
            is_training=True, grad=True)
        assert float(t[2]["md0.w_hx"].abs().sum()) > 0
        assert float(t[2]["md0.w_hy"].abs().sum()) > 0


class TestRowConvDataNormFeatmap:
    def test_row_conv_lookahead(self, rng):
        x = rng.randn(2, 5, 3).astype(np.float32)
        lens = np.array([5, 3], np.int32)
        w = np.zeros((2, 3), np.float32)
        w[0] = 1.0
        out = tseq.row_conv(torch.from_numpy(x), torch.from_numpy(lens),
                            torch.from_numpy(w))
        mask = (np.arange(5)[None, :, None] < lens[:, None, None])
        np.testing.assert_allclose(out.numpy(), x * mask, rtol=1e-5)

    def test_row_conv_layer(self, rng):
        def b(P):
            return P.layer.row_conv(_data(P, "rc_in", 4,
                                          "dense_vector_sequence"),
                                    context_len=3, act="tanh", name="rc0")
        net = Net(b, seed=0)
        assert net.tparams.get_shape("rc0.w") == (3, 4)
        net.check(*both_values({"rc_in": (
            rng.randn(2, 6, 4).astype(np.float32), [6, 4])}), grad=True)

    @pytest.mark.parametrize("strategy", ["z-score", "min-max",
                                          "decimal-scaling"])
    def test_data_norm(self, rng, strategy):
        def b(P):
            return P.layer.data_norm(_data(P, "dn_in", 4), strategy=strategy,
                                     name="dn0")
        net = Net(b, seed=0)
        for k, v in (("dn0.mean", [1.0, 2, 3, 4]), ("dn0.std", [2.0] * 4),
                     ("dn0.min", [0.0, 1, 2, 3]), ("dn0.max", [4.0] * 4),
                     ("dn0.decimal", [10.0] * 4)):
            net.jparams.values[k] = jnp.asarray(v, jnp.float32)
            net.tparams[k] = np.asarray(v, np.float32)
        j, t = net.check(*both_values(
            {"dn_in": np.array([[3.0, 4, 5, 6]], np.float32)}))
        if strategy == "z-score":
            np.testing.assert_allclose(t[0]["dn0"].array.numpy(),
                                       [[1.0, 1, 1, 1]], rtol=1e-5)

    def test_data_norm_params_are_static(self):
        topo = T.topology.Topology(T.layer.data_norm(
            _data(T, "dn_in2", 4), name="dn1"))
        spec = {s.name: s for s in topo.param_specs()}
        assert spec["dn1.mean"].attr.is_static

    @pytest.mark.parametrize("row", [True, False])
    def test_featmap_expand(self, row):
        def b(P):
            return P.layer.featmap_expand(_data(P, "fm_in", 3),
                                          num_filters=2, as_row_vector=row,
                                          name="fm0")
        j, t = Net(b).check(*both_values(
            {"fm_in": np.array([[1.0, 2, 3]], np.float32)}), atol=0.0)
        want = [[1, 2, 3, 1, 2, 3]] if row else [[1, 1, 2, 2, 3, 3]]
        np.testing.assert_array_equal(t[0]["fm0"].array.numpy(), want)


class TestNewCosts:
    def test_huber_regression_regions(self):
        out = tloss.huber_regression(torch.zeros(3, 1),
                                     torch.tensor([[0.5], [1.0], [3.0]]),
                                     delta=1.0)
        np.testing.assert_allclose(out.numpy(), [0.125, 0.5, 2.5], rtol=1e-6)

    def test_selfnorm_matches_ce_plus_penalty(self, rng):
        logits = rng.randn(4, 6).astype(np.float32)
        labels = np.array([0, 2, 3, 5], np.int32)
        parity(lambda a, b: jloss.cross_entropy_with_selfnorm(a, b, alpha=0.5),
               lambda a, b: tloss.cross_entropy_with_selfnorm(a, b, alpha=0.5),
               [logits, labels], wrt=(0,))

    def test_lambda_rank_perfect_order_is_low(self):
        rel = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
        lens = torch.tensor([4])
        good = tloss.lambda_rank(torch.tensor([[4.0, 3.0, 2.0, 1.0]]), rel,
                                 lens)
        bad = tloss.lambda_rank(torch.tensor([[1.0, 2.0, 3.0, 4.0]]), rel,
                                lens)
        assert float(good[0]) < float(bad[0])

    def test_lambda_rank_gradient_improves_ndcg(self):
        s = torch.tensor([[1.0, 0.0, 0.5]], requires_grad=True)
        f = tloss.lambda_rank(s, torch.tensor([[0.0, 2.0, 1.0]]),
                              torch.tensor([3])).sum()
        (g,) = torch.autograd.grad(f, [s])
        assert float(g[0, 1]) < float(g[0, 0])

    def test_cost_layers_build_and_run(self, rng):
        def b(P):
            L = P.layer
            fcn = L.fc(_data(P, "nc_x", 4), 4, act=None, name="nc_fc")
            lbl = _data(P, "nc_y", 4)
            return [L.huber_regression_cost(fcn, lbl, name="nc_hr"),
                    L.smooth_l1_cost(fcn, lbl, name="nc_sl"),
                    L.sum_cost_layer(fcn, name="nc_sum"),
                    L.square_error_cost(fcn, lbl, name="nc_se"),
                    L.soft_binary_class_cross_entropy(
                        L.fc(_data(P, "nc_x2", 4), 4, act="sigmoid",
                             name="nc_sig"), _data(P, "nc_p", 4),
                        name="nc_sb")]
        net = Net(b, seed=0)
        j, t = net.check(*both_values({
            "nc_x": rng.randn(3, 4).astype(np.float32),
            "nc_y": rng.randn(3, 4).astype(np.float32),
            "nc_x2": rng.randn(3, 4).astype(np.float32),
            "nc_p": rng.rand(3, 4).astype(np.float32)}), grad=True)
        for n in ("nc_hr", "nc_sl", "nc_sum"):
            assert tuple(t[0][n].array.shape) == (3,)

    def test_lambda_cost_layer(self, rng):
        def b(P):
            return P.layer.lambda_cost(
                _data(P, "lc_s", 1, "dense_vector_sequence"),
                _data(P, "lc_r", 1, "dense_vector_sequence"), name="lc0")
        j, t = Net(b).check(*both_values({
            "lc_s": (rng.randn(2, 5, 1).astype(np.float32), [5, 3]),
            "lc_r": (rng.randint(0, 3, (2, 5, 1)).astype(np.float32),
                     [5, 3])}))
        assert np.isfinite(t[0]["lc0"].array.numpy()).all()


class TestPnpairEvaluator:
    def test_counts(self):
        def b(P):
            return P.evaluator.positive_negative_pair(
                _data(P, "pn_s", 1), _data(P, "pn_l", 2, "integer_value"),
                _data(P, "pn_q", 100, "integer_value"), name="pn0")
        j, t = Net(b).check(*both_values({
            "pn_s": np.array([[0.9], [0.1], [0.2], [0.8]], np.float32),
            "pn_l": np.array([1, 0, 1, 0], np.int32),
            "pn_q": np.array([1, 1, 2, 2], np.int32)}), atol=0.0)
        assert t[0]["pn0"].array.tolist() == [1.0, 1.0, 0.0]


class TestNewOptimizers:
    """One step of each rule from the same state, both packages."""

    def _both(self, name, **kw):
        jp = {"w": jnp.asarray([1.0], jnp.float32)}
        jopt = getattr(J.optimizer, name)(**kw)
        jopt.bind([])
        jw, _ = jopt.update(jnp.asarray(0, jnp.int32),
                            {"w": jnp.asarray([0.5], jnp.float32)}, jp,
                            jopt.init_state(jp))
        tp = {"w": torch.tensor([1.0])}
        topt = getattr(T.optimizer, name)(**kw)
        tw, _ = topt.update(0, {"w": torch.tensor([0.5])}, tp,
                            topt.init_state(tp))
        np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]),
                                   rtol=1e-6)
        return float(tw["w"][0])

    def test_decayed_adagrad(self):
        w = self._both("DecayedAdagrad", learning_rate=0.1, rho=0.5)
        assert abs(w - (1.0 - 0.1 * 0.5 / (0.125 ** 0.5 + 1e-6))) < 1e-6

    def test_proximal_gd_l1_soft_threshold(self):
        assert self._both("ProximalGD", learning_rate=0.1, l1=10.0) == 0.0

    def test_proximal_adagrad_shrinks(self):
        w_plain = self._both("AdaGrad", learning_rate=0.1)
        w_prox = self._both("ProximalAdagrad", learning_rate=0.1, l2=1.0)
        assert 0 < w_prox < w_plain


class TestDeconv3D:
    def test_shapes_and_grad(self, rng):
        def b(P):
            return P.layer.img_conv3d_transpose(
                _data(P, "dc_in", 36), filter_size=2, num_filters=4,
                shape=(2, 2, 3, 3), stride=2, name="dc0")
        net = Net(b, seed=0)
        assert net.tout.shape3d == (4, 4, 6, 6)
        j, t = net.check(*both_values(
            {"dc_in": rng.randn(2, 36).astype(np.float32)}), grad=True)
        assert tuple(t[0]["dc0"].array.shape) == (2, 4 * 4 * 6 * 6)


class TestNumericGrads:
    """The reference's numeric-gradient cases, held here against
    ``jax.grad``."""

    def test_row_conv_grads(self, rng):
        lens = np.array([5, 3], np.int32)
        parity(lambda x, w: jseq.row_conv(x, jnp.asarray(lens), w),
               lambda x, w: tseq.row_conv(x, torch.from_numpy(lens), w),
               [rng.randn(2, 5, 3).astype(np.float32),
                rng.randn(2, 3).astype(np.float32)], wrt=(0, 1))

    def test_mdlstm_grads(self, rng):
        args = [rng.randn(1, 3, 3, 4).astype(np.float32)] + [
            (rng.randn(*s) * 0.3).astype(np.float32)
            for s in ((4, 15), (3, 15), (3, 15))]
        for rx, ry in ((True, False), (False, True)):
            parity(lambda *a: jrnn.mdlstm(*a, reverse_x=rx, reverse_y=ry),
                   lambda *a: trnn.mdlstm(*a, reverse_x=rx, reverse_y=ry),
                   args, wrt=(0, 1, 2, 3))

    def test_lambda_rank_grad(self, rng):
        rel = rng.randint(0, 3, (2, 4)).astype(np.float32)
        lens = np.array([4, 3], np.int32)
        parity(lambda s: jloss.lambda_rank(s, jnp.asarray(rel),
                                           jnp.asarray(lens)),
               lambda s: tloss.lambda_rank(s, torch.from_numpy(rel),
                                           torch.from_numpy(lens)),
               [rng.randn(2, 4).astype(np.float32)], wrt=(0,))
