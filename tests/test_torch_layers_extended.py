"""The port's extended layer surface against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_layers_extended.py`` but its network
composites (those are in ``test_torch_networks.py``): the elementwise
and structural layers, image geometry, the 3-D layers, sequence slicing,
mixed layers with every projection, selective fc, hsigmoid and NCE
(each trained a few steps by the port), the review regressions and the
nested-sequence selection; each graph built in both packages and held
against the JAX package forward and backward. Plus the places where the
port had to repeat JAX's own arithmetic: ``jax.image.resize``'s bilinear
weights up and down (an odd scale too), ``lax.conv_transpose``'s
asymmetric SAME pads in 3-D at stride 2, ``conv_general_dilated_patches``'
C-major patch order in ``block_expand``, and the random draws (dropout
masks, ``sampling_id`` ids, ``nce`` negatives) equal to JAX's for the
same key.

Tolerances: fp32 forward 1e-5, gradients 1e-4 (of max(1, max|JAX
value|)); ids, masks and lengths exact.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch.ops import prng
from tests.torch_layers_util import Net, both_values

torch.set_num_threads(1)


def _data(P, name, dim, kind="dense_vector", chans=None, shape=None):
    d = P.layer.data(name, getattr(P.data_type, kind)(dim))
    if chans is not None:
        d._out_channels = chans
    if shape is not None:
        d._img_shape = shape
    return d


def _attr(P, name):
    return P.attr.ParamAttr(name=name)


class TestElementwise:
    def test_interpolation_power_norms_clip(self, rng):
        B, Fd = 4, 6

        def b(P):
            L = P.layer
            dx, dy, dw = (_data(P, "x", Fd), _data(P, "y", Fd),
                          _data(P, "w", 1))
            return [L.interpolation([dx, dy], dw, name="interp"),
                    L.power(dx, dw, name="pow"),
                    L.sum_to_one_norm(dx, name="s1"),
                    L.row_l2_norm(dx, name="l2"),
                    L.clip(dx, min=0.6, max=1.2, name="clip")]
        x = rng.rand(B, Fd).astype(np.float32) + 0.5
        y = rng.rand(B, Fd).astype(np.float32) + 0.5
        w = rng.rand(B, 1).astype(np.float32)
        Net(b).check(*both_values({"x": x, "y": y, "w": w}))

    def test_structural(self, rng):
        def b(P):
            L = P.layer
            dx = _data(P, "x", 6)
            return [L.resize(dx, size=3, name="rsz"), L.trans(dx, name="tr"),
                    L.repeat(dx, 2, name="rep_row"),
                    L.repeat(dx, 2, as_row_vector=False, act="tanh",
                             name="rep_el"),
                    L.maxout(dx, groups=2, name="mo")]
        Net(b).check(*both_values({"x": rng.randn(4, 6).astype(np.float32)}))

    def test_multiplex_out_prod_linear_comb(self, rng):
        B, Fd = 4, 5

        def b(P):
            L = P.layer
            da, db = _data(P, "a", Fd), _data(P, "b", Fd)
            di = _data(P, "i", 2, "integer_value")
            dwt, dvs = _data(P, "wt", 2), _data(P, "vs", 2 * Fd)
            return [L.multiplex([di, da, db], name="mux"),
                    L.out_prod(da, db, name="op"),
                    L.linear_comb(dwt, dvs, size=Fd, name="lc")]
        Net(b).check(*both_values({
            "a": rng.randn(B, Fd).astype(np.float32),
            "b": rng.randn(B, Fd).astype(np.float32),
            "i": np.array([0, 1, 0, 1], np.int32),
            "wt": rng.randn(B, 2).astype(np.float32),
            "vs": rng.randn(B, 2 * Fd).astype(np.float32)}))

    def test_conv_shift(self, rng):
        def b(P):
            return P.layer.conv_shift(_data(P, "a", 7), _data(P, "k", 3),
                                      name="cs")
        Net(b).check(*both_values({"a": rng.randn(3, 7).astype(np.float32),
                                   "k": rng.randn(3, 3).astype(np.float32)}))

    def test_tensor_scale_shift_prelu_gated(self, rng):
        def b(P):
            L = P.layer
            da, db = _data(P, "a", 4), _data(P, "b", 5)
            return [L.tensor(da, db, size=6, act="linear", name="tp",
                             bias_attr=False),
                    L.scale_shift(da, name="ss"), L.prelu(da, name="pr"),
                    L.gated_unit(da, size=6, act="tanh", name="gu")]
        net = Net(b)
        assert set(net.tparams.names()) == {
            "tp.w", "ss.w", "ss.b", "pr.w", "gu_input.w", "gu_input.b",
            "gu_gate.w", "gu_gate.b"}
        net.check(*both_values({"a": rng.randn(3, 4).astype(np.float32),
                                "b": rng.randn(3, 5).astype(np.float32)}),
                  grad=True)

    def test_eos(self):
        def b(P):
            return P.layer.eos(_data(P, "i", 5, "integer_value"), eos_id=1,
                               name="e")
        j, t = Net(b).check(*both_values(
            {"i": np.array([[1], [3], [1]], np.int32)}))
        np.testing.assert_array_equal(t[0]["e"].array.reshape(-1).numpy(),
                                      [1.0, 0.0, 1.0])


class TestImageGeometry:
    def test_pad_crop(self, rng):
        C, H, W = 3, 4, 4

        def b(P):
            L = P.layer
            dx = _data(P, "x", C * H * W, chans=C)
            p = L.pad(dx, pad_c=(1, 0), pad_h=(1, 1), pad_w=(0, 2), name="p")
            return [p, L.crop(p, offset=(0, 1, 0), shape=(C + 1, H, W + 2),
                              name="c")]
        j, t = Net(b).check(*both_values(
            {"x": rng.randn(2, C * H * W).astype(np.float32)}))
        assert tuple(t[0]["p"].array.shape) == (2, H + 2, W + 2, C + 1)

    @pytest.mark.parametrize("hw,out_yx", [
        ((4, 6), (2, 3)),          # down by 2 (the reference case)
        ((4, 6), (7, 9)),          # up, non-integer scales
        ((5, 7), (3, 4)),          # down at odd scales: antialiased
        ((6, 4), (6, 10)),         # one axis unchanged
    ])
    def test_bilinear_rotate(self, rng, hw, out_yx):
        """``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
        triangle kernel widened by the scale when downsampling."""
        C, (H, W) = 2, hw

        def b(P):
            L = P.layer
            dx = _data(P, "x", C * H * W, chans=C, shape=(H, W))
            return [L.bilinear_interp(dx, out_size_x=out_yx[1],
                                      out_size_y=out_yx[0], name="bi"),
                    L.rotate(dx, name="rot")]
        j, t = Net(b).check(*both_values(
            {"x": rng.randn(2, C * H * W).astype(np.float32)}))
        assert tuple(t[0]["bi"].array.shape) == (2,) + out_yx + (C,)

    def test_cross_channel_norm(self, rng):
        def b(P):
            return P.layer.cross_channel_norm(_data(P, "x", 12, chans=3),
                                              name="ccn")
        Net(b).check(*both_values({"x": rng.randn(2, 12).astype(np.float32)}),
                     grad=True)

    @pytest.mark.parametrize("C,blk,stride,pad", [(1, 2, 2, 0), (2, 3, 1, 1),
                                                  (3, 2, 1, 0)])
    def test_block_expand(self, rng, C, blk, stride, pad):
        """Each timestep is one block, C-major (c, y, x): the order of
        ``lax.conv_general_dilated_patches``."""
        H = W = 4

        def b(P):
            return P.layer.block_expand(
                _data(P, "x", C * H * W, chans=C), block_x=blk, block_y=blk,
                stride_x=stride, stride_y=stride, padding_x=pad,
                padding_y=pad, name="be")
        flat = rng.randn(2, C * H * W).astype(np.float32)
        j, t = Net(b).check(*both_values({"x": flat}), atol=0.0)
        chw = np.pad(flat.reshape(2, C, H, W),
                     ((0, 0), (0, 0), (pad, pad), (pad, pad)))
        np.testing.assert_array_equal(t[0]["be"].array[0, 0].numpy(),
                                      chw[0, :, :blk, :blk].reshape(-1))

    def test_conv3d_pool3d(self, rng):
        C, D, H, W = 2, 3, 4, 4

        def b(P):
            L = P.layer
            dx = _data(P, "x", C * D * H * W)
            return [L.img_conv3d(dx, filter_size=2, num_filters=3,
                                 shape=(C, D, H, W), act="linear", name="c3",
                                 bias_attr=False),
                    L.img_conv3d(dx, filter_size=3, num_filters=2,
                                 shape=(C, D, H, W), stride=2, padding=1,
                                 name="c3s"),
                    L.img_pool3d(dx, pool_size=2, shape=(C, D, H, W),
                                 name="p3"),
                    L.img_pool3d(dx, pool_size=2, shape=(C, D, H, W),
                                 stride=1, padding=1, pool_type="avg",
                                 name="p3a")]
        Net(b).check(*both_values(
            {"x": rng.randn(2, C * D * H * W).astype(np.float32)}),
            grad=True)

    @pytest.mark.parametrize("k,dhw", [(3, (3, 4, 5)), (2, (2, 3, 3)),
                                       (4, (3, 3, 2))])
    def test_conv3d_transpose_same_stride2(self, rng, k, dhw):
        """``lax.conv_transpose`` with SAME padding at stride 2: XLA's pads
        of the dilated input (asymmetric for k = 3 and 4), the kernel not
        flipped."""
        C = 2

        def b(P):
            return P.layer.img_conv3d_transpose(
                _data(P, "x", C * int(np.prod(dhw))), filter_size=k,
                num_filters=3, shape=(C,) + dhw, stride=2, name="dc3")
        net = Net(b)
        j, t = net.check(*both_values({"x": rng.randn(
            2, C * int(np.prod(dhw))).astype(np.float32)}), grad=True)
        assert t[0]["dc3"].array.shape[1] == 3 * 8 * int(np.prod(dhw))


class TestSequenceSlicing:
    def test_seq_reshape(self, rng):
        def b(P):
            return P.layer.seq_reshape(_data(P, "x", 6, "dense_vector_sequence"),
                                       reshape_size=3, name="sr")
        j, t = Net(b).check(*both_values({"x": (
            rng.randn(2, 4, 6).astype(np.float32), [4, 2])}))
        assert t[0]["sr"].lengths.tolist() == [8, 4]

    def test_seq_slice_sub_seq(self, rng):
        def b(P):
            L = P.layer
            dx = _data(P, "x", 3, "dense_vector_sequence")
            ds, de = _data(P, "s", 1), _data(P, "e", 1)
            return [L.seq_slice(dx, starts=ds, ends=de, name="sl"),
                    L.seq_slice(dx, ends=de, name="sl_e"),
                    L.sub_seq(dx, ds, de, name="sub")]
        j, t = Net(b).check(*both_values({
            "x": (rng.randn(2, 5, 3).astype(np.float32), [5, 4]),
            "s": np.array([[1], [0]], np.float32),
            "e": np.array([[4], [2]], np.float32)}))
        assert t[0]["sl"].lengths.tolist() == [3, 2]

    def test_kmax_seq_score(self, rng):
        def b(P):
            return P.layer.kmax_seq_score(
                _data(P, "x", 1, "dense_vector_sequence"), beam_size=2,
                name="km")
        Net(b).check(*both_values({"x": (
            rng.randn(2, 5, 1).astype(np.float32), [5, 3])}))


class TestMixedProjections:
    def test_mixed_sums_projections(self, rng):
        def b(P):
            L, Pr = P.layer, P.projection
            dx, dy = _data(P, "x", 4), _data(P, "y", 5)
            return L.mixed(size=5, input=[
                Pr.full_matrix_projection(dx, size=5,
                                          param_attr=_attr(P, "fm.w")),
                Pr.identity_projection(dy),
                Pr.dotmul_projection(dy, param_attr=_attr(P, "dm.w")),
                Pr.scaling_projection(dy, param_attr=_attr(P, "sc.w")),
            ], name="mx", bias_attr=False)
        Net(b).check(*both_values({"x": rng.randn(3, 4).astype(np.float32),
                                   "y": rng.randn(3, 5).astype(np.float32)}),
                     grad=True)

    def test_trans_table_slice_context(self, rng):
        def b(P):
            L, Pr = P.layer, P.projection
            dx, di = _data(P, "x", 4), _data(P, "i", 7, "integer_value")
            return [
                L.mixed(size=5, input=[Pr.trans_full_matrix_projection(
                    dx, size=5, param_attr=_attr(P, "tfm.w"))], name="m1",
                    bias_attr=True),
                L.mixed(size=5, input=[Pr.table_projection(
                    di, size=5, param_attr=_attr(P, "tab.w"))], name="m2",
                    bias_attr=False),
                L.mixed(size=2, input=[Pr.slice_projection(
                    dx, [(0, 1), (3, 4)])], name="m3", bias_attr=False),
                L.mixed(size=2, input=[Pr.identity_projection(
                    dx, offset=1, size=2)], name="m4")]
        Net(b).check(*both_values({
            "x": rng.randn(3, 4).astype(np.float32),
            "i": rng.randint(0, 7, (3,)).astype(np.int32)}), grad=True)

    def test_context_projection_and_dotmul_operator(self, rng):
        def b(P):
            L, Pr = P.layer, P.projection
            dx = _data(P, "x", 3, "dense_vector_sequence")
            da, db = _data(P, "a", 3), _data(P, "b", 3)
            return [L.mixed(size=9, input=[Pr.context_projection(
                        dx, context_len=3)], name="cp", bias_attr=False),
                    L.mixed(size=3, input=[Pr.dotmul_operator(
                        da, db, scale=2.0)], name="do", bias_attr=False),
                    L.context_projection(dx, context_len=2, context_start=0,
                                         name="cpl")]
        Net(b).check(*both_values({
            "x": (rng.randn(2, 4, 3).astype(np.float32), [4, 2]),
            "a": rng.randn(2, 3).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}))


class TestSampledOutputs:
    def test_selective_fc_matches_dense_columns(self, rng):
        def b(P):
            return P.layer.selective_fc(
                _data(P, "x", 4), _data(P, "s", 10, "integer_value"),
                size=10, act="linear", name="sf")
        Net(b).check(*both_values({
            "x": rng.randn(3, 4).astype(np.float32),
            "s": rng.randint(0, 10, (3, 3)).astype(np.int32)}), grad=True)

    def test_hsigmoid_is_a_distribution(self, rng):
        B, D, C = 2, 5, 6

        def b(P):
            return P.layer.hsigmoid(_data(P, "x", D),
                                    _data(P, "l", C, "integer_value"),
                                    num_classes=C, name="hs")
        net = Net(b, seed=3)
        x = rng.randn(B, D).astype(np.float32)
        total = np.zeros(B)
        for c in range(C):
            j, t = net.check(*both_values(
                {"x": x, "l": np.full((B,), c, np.int32)}), grad=True)
            total += np.exp(-t[0]["hs"].array.detach().double().numpy())
        np.testing.assert_allclose(total, 1.0, rtol=1e-5)

    def _trains(self, net, feeds, lr, key=None, steps=40):
        """Plain SGD on the port's gradients; the first step's loss and
        gradients are JAX's (``Net.check``); returns the losses."""
        net.check(*feeds, grad=True, is_training=key is not None, key=key)
        name = net.ttopo.outputs[0].name
        vals = {k: v.clone() for k, v in net.tparams.values.items()}
        hist = []
        for i in range(steps):
            leaves = {k: v.requires_grad_() for k, v in vals.items()}
            o, _ = net.tfwd(leaves, {}, feeds[1], is_training=key is not None,
                            dropout_key=None if key is None else
                            prng.fold_in(prng.prng_key(key), i))
            loss = o[name].array.mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            vals = {k: (v - lr * g).detach()
                    for (k, v), g in zip(leaves.items(), grads)}
            hist.append(loss.item())
        return hist

    def test_hsigmoid_trains(self, rng):
        def b(P):
            return P.layer.hsigmoid(_data(P, "x", 6),
                                    _data(P, "l", 5, "integer_value"),
                                    num_classes=5, name="hs")
        feeds = both_values({"x": rng.randn(8, 6).astype(np.float32),
                             "l": (np.arange(8) % 5).astype(np.int32)})
        hist = self._trains(Net(b, seed=0), feeds, 0.5)
        assert hist[-1] < hist[0] * 0.5

    def test_nce_trains(self, rng):
        def b(P):
            return P.layer.nce(_data(P, "x", 6),
                               _data(P, "l", 20, "integer_value"),
                               num_classes=20, num_neg_samples=5, name="nc")
        feeds = both_values({"x": rng.randn(8, 6).astype(np.float32),
                             "l": (np.arange(8) % 20).astype(np.int32)})
        net = Net(b, seed=0)
        net.check(*feeds, grad=True)              # the PRNGKey(0) negatives
        hist = self._trains(net, feeds, 0.2, key=0)
        assert hist[-1] < hist[0] * 0.7, (hist[0], hist[-1])


class TestRandomDrawsMatchJax:
    """Masks, sampled ids and negative ids equal to the JAX package's on
    the same key — not merely close."""

    @pytest.mark.parametrize("key", [0, 5, 99])
    def test_nce_negatives(self, key):
        from paddle_tpu.topology import ForwardContext as JCtx
        from paddle_tpu_torch.topology import ForwardContext as TCtx
        jk = JCtx(dropout_key=jax.random.PRNGKey(key)).layer_key("nc")
        tk = TCtx(dropout_key=prng.prng_key(key)).layer_key("nc")
        want = np.asarray(jax.random.randint(jk, (16, 10), 0, 3000))
        np.testing.assert_array_equal(
            prng.randint(tk, (16, 10), 0, 3000).numpy(), want)
        np.testing.assert_array_equal(
            prng.randint(prng.prng_key(0), (4, 7), 0, 20).numpy(),
            np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 7), 0,
                                          20)))

    @pytest.mark.parametrize("key", [1, 2])
    def test_sampling_id_and_dropout(self, rng, key):
        def b(P):
            L = P.layer
            dx = _data(P, "x", 12)
            p = L.fc(dx, 50, act="softmax", name="p")
            return [L.sampling_id(p, name="sid"),
                    L.dropout(L.fc(dx, 40, name="h"), 0.3, name="dr")]
        net = Net(b)
        feeds = both_values({"x": rng.randn(64, 12).astype(np.float32)})
        j, t = net.check(*feeds, is_training=True, key=key, atol=1e-6)
        np.testing.assert_array_equal(t[0]["sid"].array.numpy(),
                                      np.asarray(j[0]["sid"].array))
        np.testing.assert_array_equal(t[0]["dr"].array.numpy() == 0,
                                      np.asarray(j[0]["dr"].array) == 0)
        # without a key: argmax
        j, t = net.check(*feeds)
        np.testing.assert_array_equal(
            t[0]["sid"].array.numpy(),
            np.argmax(np.asarray(j[0]["p"].array), -1) if "p" in j[0]
            else np.asarray(j[0]["sid"].array))


class TestReviewRegressions:
    def test_conv3d_pool3d_chain_is_channel_major(self, rng):
        C, D, H, W = 2, 4, 4, 4

        def b(P):
            L = P.layer
            dx = _data(P, "x", C * D * H * W)
            c3 = L.img_conv3d(dx, filter_size=1, num_filters=C,
                              shape=(C, D, H, W), act="linear", name="c3a",
                              bias_attr=False)
            return [c3, L.img_pool3d(c3, pool_size=2, shape=c3.shape3d,
                                     name="p3a")]
        Net(b).check(*both_values(
            {"x": rng.randn(2, C * D * H * W).astype(np.float32)}), grad=True)

    def test_conv_maxout_conv_chain(self, rng):
        C, H, W = 4, 6, 6

        def b(P):
            L = P.layer
            dx = _data(P, "x", C * H * W)
            c1 = L.img_conv(dx, 3, num_filters=8, num_channels=C,
                            img_size=(H, W), act="relu", name="cc1")
            mo = L.maxout(c1, groups=2, name="mo1")
            assert mo._out_channels == 4
            return L.img_conv(mo, 3, num_filters=2, act="relu", name="cc2")
        Net(b).check(*both_values(
            {"x": rng.randn(2, C * H * W).astype(np.float32)}), grad=True)

    def test_prelu_on_conv_output(self, rng):
        C, H, W = 3, 4, 4

        def b(P):
            L = P.layer
            c1 = L.img_conv(_data(P, "x", C * H * W), 3, num_filters=C,
                            num_channels=C, img_size=(H, W), act="linear",
                            name="pc1")
            return L.prelu(c1, name="pr4")
        net = Net(b)
        assert net.tparams.get_shape("pr4.w") == (C,)
        net.check(*both_values(
            {"x": rng.randn(2, C * H * W).astype(np.float32)}), grad=True)

    def test_sequence_metadata_follows_data_parent(self, rng):
        def b(P):
            L = P.layer
            dx = _data(P, "x", 4, "dense_vector_sequence")
            dy = _data(P, "y", 4, "dense_vector_sequence")
            return L.interpolation([dx, dy], _data(P, "w", 1), name="iseq")
        j, t = Net(b).check(*both_values({
            "x": (rng.randn(2, 3, 4).astype(np.float32), [3, 2]),
            "y": (rng.randn(2, 3, 4).astype(np.float32), [3, 2]),
            "w": rng.rand(2, 1).astype(np.float32)}))
        assert t[0]["iseq"].lengths.tolist() == [3, 2]

    def test_conv_shift_even_kernel_rejected(self):
        from paddle_tpu_torch.utils.enforce import EnforceError
        with pytest.raises(EnforceError, match="odd"):
            T.layer.conv_shift(_data(T, "a", 6), _data(T, "k", 4))


def test_sub_nested_seq_layer():
    def b(P):
        nested = _data(P, "sns_in", 2, "dense_vector_sub_sequence")
        sel = _data(P, "sns_sel", 4, "integer_value_sequence")
        return P.layer.sub_nested_seq(nested, sel, name="sns_out")
    s0 = [[[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]], [[4.0, 4.0]]]
    s1 = [[[5.0, 5.0]], [[6.0, 6.0], [7.0, 7.0]]]
    j, t = Net(b).check_rows([(s0, [1, 0]), (s1, [1])])
    v = t[0]["sns_out"]
    assert v.lengths.tolist() == [4, 2]
    assert v.sub_lengths.tolist()[0][:2] == [1, 3]
