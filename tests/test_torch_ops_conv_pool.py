"""The port's conv and pool ops against ``paddle_tpu``'s on the CPU.

Every case of ``tests/test_ops_conv_pool.py`` and the bf16 conv case of
``tests/test_ops_mixed_precision.py``, plus XLA's asymmetric ``"SAME"``
padding at stride 2 (k = 3 and 4, odd and even sizes) in conv and both
pools, the transposed conv at strides 1 and 2 with both paddings, and
the space-to-depth stem. Inputs come from a seeded
``numpy.random.RandomState``; the same arrays go through both packages.

Tolerances: fp32 forward 1e-5 and gradients 1e-4 (of max(1, max|JAX
value|): the two libraries sum a convolution in different orders); bf16
within 2 bf16 ulps of max(|JAX value|, 2^-6) (both accumulate in fp32
and round once, so a sum near a rounding boundary may round the other
way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import conv as jconv
from paddle_tpu.ops import pool as jpool
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import pool as tpool
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS
from tests.torch_ops_util import bf16_ulp_err, parity, to_j, to_t

torch.set_num_threads(1)


def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _conv_parity(rng, xs, ws, **kw):
    parity(lambda a, b: jconv.conv2d(a, b, **kw),
           lambda a, b: tconv.conv2d(a, b, **kw),
           [_x(rng, *xs), _x(rng, *ws)], wrt=(0, 1))


def test_conv2d_valid(rng):
    _conv_parity(rng, (2, 8, 8, 3), (3, 3, 3, 4), padding="VALID")


def test_conv2d_stride_pad(rng):
    _conv_parity(rng, (1, 7, 7, 2), (3, 3, 2, 5), stride=2, padding=1)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("hw", [7, 8])
def test_conv2d_same_stride2_asymmetric(rng, k, hw):
    """XLA's SAME at stride 2: the extra pad row/column goes bottom/right."""
    _conv_parity(rng, (2, hw, hw + 1, 3), (k, k, 3, 4), stride=2,
                 padding="SAME")


def test_conv2d_explicit_pairs_and_dilation(rng):
    _conv_parity(rng, (1, 9, 8, 2), (3, 2, 2, 3),
                 padding=((0, 2), (1, 0)))
    _conv_parity(rng, (1, 9, 9, 2), (3, 3, 2, 3), padding="SAME",
                 dilation=2)


def test_conv2d_grad(rng):
    _conv_parity(rng, (1, 5, 5, 2), (3, 3, 2, 2), padding="VALID")


def test_depthwise(rng):
    parity(lambda a, b: jconv.depthwise_conv2d(a, b, padding="VALID"),
           lambda a, b: tconv.depthwise_conv2d(a, b, padding="VALID"),
           [_x(rng, 1, 6, 6, 3), _x(rng, 3, 3, 1, 3)], wrt=(0, 1))
    parity(lambda a, b: jconv.depthwise_conv2d(a, b, stride=2),
           lambda a, b: tconv.depthwise_conv2d(a, b, stride=2),
           [_x(rng, 2, 7, 6, 2), _x(rng, 3, 3, 1, 4)], wrt=(0, 1))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_conv2d_transpose(rng, padding, stride, k):
    """``lax.conv_transpose`` with ``transpose_kernel=False``: the HWIO
    kernel not flipped, XLA's own SAME/VALID rule."""
    t, _ = parity(
        lambda a, b: jconv.conv2d_transpose(a, b, stride=stride,
                                            padding=padding),
        lambda a, b: tconv.conv2d_transpose(a, b, stride=stride,
                                            padding=padding),
        [_x(rng, 2, 4, 5, 3), _x(rng, k, k, 3, 6)], wrt=(0, 1))


def test_conv2d_transpose_shape(rng):
    out = tconv.conv2d_transpose(to_t(_x(rng, 2, 4, 4, 3)),
                                 to_t(_x(rng, 2, 2, 3, 6)), stride=2,
                                 padding="VALID")
    assert tuple(out.shape) == (2, 8, 8, 6)


def test_max_pool(rng):
    parity(lambda a: jpool.max_pool2d(a, 2), lambda a: tpool.max_pool2d(a, 2),
           [_x(rng, 2, 4, 4, 3)], wrt=(0,))


def test_avg_pool_excludes_padding(rng):
    x = np.ones((1, 3, 3, 1), np.float32)
    t, _ = parity(
        lambda a: jpool.avg_pool2d(a, 2, stride=2, padding=((0, 1), (0, 1))),
        lambda a: tpool.avg_pool2d(a, 2, stride=2, padding=((0, 1), (0, 1))),
        [x])
    np.testing.assert_allclose(t.numpy(), np.ones((1, 2, 2, 1)), rtol=1e-6)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("hw", [7, 8])
@pytest.mark.parametrize("kind", ["max", "avg", "avg_incl"])
def test_pool_same_stride2_asymmetric(rng, k, hw, kind):
    """SAME at stride 2 pads bottom/right; the average divides by the
    real elements of each window (or k*k with ``count_include_pad``)."""
    if kind == "max":
        jf = lambda a: jpool.max_pool2d(a, k, stride=2, padding="SAME")
        tf = lambda a: tpool.max_pool2d(a, k, stride=2, padding="SAME")
    else:
        inc = kind == "avg_incl"
        jf = lambda a: jpool.avg_pool2d(a, k, stride=2, padding="SAME",
                                        count_include_pad=inc)
        tf = lambda a: tpool.avg_pool2d(a, k, stride=2, padding="SAME",
                                        count_include_pad=inc)
    parity(jf, tf, [_x(rng, 2, hw, hw + 1, 3)], wrt=(0,))


def test_global_pools(rng):
    x = _x(rng, 2, 3, 3, 4)
    parity(jpool.global_avg_pool2d, tpool.global_avg_pool2d, [x], wrt=(0,))
    parity(jpool.global_max_pool2d, tpool.global_max_pool2d, [x], wrt=(0,))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_spp_shape(rng, pool_type):
    t, _ = parity(lambda a: jpool.spp(a, 3, pool_type),
                  lambda a: tpool.spp(a, 3, pool_type),
                  [_x(rng, 2, 7, 10, 3)], wrt=(0,))
    assert tuple(t.shape) == (2, 21 * 3)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_spp_empty_cell_reference_fault(rng, pool_type):
    """ROADMAP C8: width 9 at 4 bins pads to 12 with windows of 3, so the
    last column of cells is padding only. The reference returns -inf
    (max) or NaN (avg) there; the port returns 0. Every other cell and
    the gradient agree."""
    x = _x(rng, 2, 8, 9, 3)
    j = np.asarray(jpool.spp(to_j(x), 3, pool_type))
    xt = to_t(x, True)
    t = tpool.spp(xt, 3, pool_type)
    level = slice(3 * 5, 3 * 21)                  # the 4 x 4 level
    jl = j[:, level].reshape(2, 4, 4, 3)
    tl = t.detach().numpy()[:, level].reshape(2, 4, 4, 3)
    bad = -np.inf if pool_type == "max" else np.nan
    np.testing.assert_array_equal(jl[:, :, 3], np.full((2, 4, 3), bad))
    np.testing.assert_array_equal(tl[:, :, 3], np.zeros((2, 4, 3)))
    keep = np.ones(j.shape, bool)
    keep[:, level] = np.broadcast_to(
        (np.arange(4) < 3)[None, None, :, None], (2, 4, 4, 3)).reshape(2, -1)
    np.testing.assert_allclose(t.detach().numpy()[keep], j[keep], atol=1e-5)
    g = torch.autograd.grad(t.sum(), xt)[0]
    assert torch.isfinite(g).all()


class TestSpaceToDepthStem:
    """space_to_depth + transformed weights reproduce the strided conv,
    and both match the JAX package's."""

    @pytest.mark.parametrize("k,block,hw", [
        (7, 2, 32), (3, 2, 16), (5, 2, 24), (3, 4, 16), (5, 4, 24),
        (1, 2, 8),
    ])
    def test_equivalence_general(self, rng, k, block, hw):
        x = _x(rng, 2, hw, hw, 3)
        w = _x(rng, k, k, 3, 8)
        xt, wt = to_t(x), to_t(w)
        ref = tconv.conv2d(xt, wt, stride=block, padding=k // 2)
        xs = tconv.space_to_depth(xt, block)
        ws, pads = tconv.space_to_depth_conv_transform(wt, block)
        got = tconv.conv2d(xs, ws, stride=1, padding=pads)
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4
        jws, jpads = jconv.space_to_depth_conv_transform(to_j(w), block)
        assert pads == jpads
        np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
        np.testing.assert_array_equal(
            xs.numpy(), np.asarray(jconv.space_to_depth(to_j(x), block)))

    def test_s2d_conv_layer_matches_img_conv(self, rng):
        """The ResNet stem's swap (the layer API's ``space_to_depth_conv``
        against ``img_conv(stride=2, padding=3)``) at the op level, with
        the gradient flowing back to the canonical 7x7 weights."""
        x = _x(rng, 2, 32, 32, 3)
        w = _x(rng, 7, 7, 3, 8)

        def stem(conv, xa, wa):
            ws, pads = conv.space_to_depth_conv_transform(wa, 2)
            return conv.conv2d(conv.space_to_depth(xa, 2), ws, padding=pads)

        t, _ = parity(lambda a, b: stem(jconv, a, b),
                      lambda a, b: stem(tconv, a, b), [x, w], wrt=(0, 1))
        plain = tconv.conv2d(to_t(x), to_t(w), stride=2, padding=3)
        assert (t - plain).abs().max().item() <= 1e-4


@pytest.fixture
def bf16_compute():
    old = (JFLAGS.get("compute_dtype"), TFLAGS.get("compute_dtype"))
    JFLAGS.set("compute_dtype", "bfloat16")
    TFLAGS.set("compute_dtype", "bfloat16")
    yield
    JFLAGS.set("compute_dtype", old[0])
    TFLAGS.set("compute_dtype", old[1])


def test_conv_bf16_grad(bf16_compute, rng):
    """The bf16 compute policy: activations stay bf16, fp32 master
    weights get fp32 gradients; values within 2 bf16 ulps of JAX's."""
    x, w = _x(rng, 2, 8, 8, 3), _x(rng, 3, 3, 3, 4)
    jo = jconv.conv2d(to_j(x), to_j(w), padding="SAME")
    xt, wt = to_t(x, True), to_t(w, True)
    to = tconv.conv2d(xt, wt, padding="SAME")
    assert to.dtype == torch.bfloat16
    assert bf16_ulp_err(to, jo) <= 2
    jg = jax.grad(lambda a, b: jconv.conv2d(a, b).astype(jnp.float32).sum(),
                  argnums=(0, 1))(to_j(x), to_j(w))
    tg = torch.autograd.grad(to.float().sum(), (xt, wt))
    for g, e in zip(tg, jg):
        assert g.dtype == torch.float32
        assert bf16_ulp_err(g, e) <= 2
