"""The port's math, activation, top-k and loss ops against
``paddle_tpu``'s on the CPU.

Every case of ``tests/test_ops_math.py``'s dense half (matmul, linear,
activations, top-k), of ``tests/test_ops_norm_loss.py``'s loss half and
the bf16 matmul case of ``tests/test_ops_mixed_precision.py``, plus
every activation of the name table, the 13 losses, ties in ``top_k``
(to the lower index, as ``lax.top_k``), ``max_id`` over NaN rows and
``lambda_rank``'s stable rankings.

Tolerances: fp32 forward 1e-5, gradients 1e-4 (of max(1, max|JAX
value|)); bf16 within 2 bf16 ulps of max(|JAX value|, 2^-6); top-k
indices and ``max_id`` exactly.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops import activations as jact
from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import math as jmath
from paddle_tpu.ops import topk as jtopk
from paddle_tpu.utils.flags import GLOBAL_FLAGS as JFLAGS
from paddle_tpu_torch.ops import activations as tact
from paddle_tpu_torch.ops import loss as tloss
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import topk as ttopk
from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS as TFLAGS
from tests.torch_ops_util import bf16_ulp_err, parity, to_j, to_t

torch.set_num_threads(1)


def _x(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_matmul_fp32_exact(rng):
    a, b = _x(rng, 8, 16), _x(rng, 16, 4)
    t, _ = parity(jmath.matmul, tmath.matmul, [a, b], wrt=(0, 1))
    np.testing.assert_allclose(t.detach().numpy(), a @ b, rtol=1e-5,
                               atol=1e-5)
    # batched operands broadcast as jnp.matmul
    parity(jmath.matmul, tmath.matmul, [_x(rng, 3, 2, 5), _x(rng, 5, 4)],
           wrt=(0, 1))


def test_matmul_integer_operands_skip_the_cast():
    a = np.arange(12, dtype=np.int32).reshape(3, 4) * 100
    b = np.arange(8, dtype=np.int32).reshape(4, 2) * 7
    parity(jmath.matmul, tmath.matmul, [a, b])


def test_linear_bias(rng):
    parity(jmath.linear, tmath.linear,
           [_x(rng, 4, 8), _x(rng, 8, 3), _x(rng, 3)], wrt=(0, 1, 2))


def test_outer(rng):
    parity(jmath.outer, tmath.outer, [_x(rng, 5), _x(rng, 3)], wrt=(0, 1))


@pytest.mark.parametrize("name", sorted(jact._REGISTRY))
def test_activations(rng, name):
    x = _x(rng, 5, 7, scale=3.0)
    if name == "log":
        x = np.abs(x) + np.float32(0.1)
    parity(jact.get(name), tact.get(name), [x], wrt=(0,))
    assert tact.get(name) is tact._REGISTRY[name]


def test_activation_extras(rng):
    x = _x(rng, 5, 7, scale=20.0)
    parity(lambda a: jact.brelu(a, 1.0, 6.0), lambda a: tact.brelu(a, 1.0, 6.0),
           [x], wrt=(0,))
    parity(lambda a: jact.log_softmax(a, 0), lambda a: tact.log_softmax(a, 0),
           [x / 20], wrt=(0,))
    with pytest.raises(KeyError):
        tact.get("nope")


def test_topk(rng):
    x = _x(rng, 3, 10)
    parity(lambda a: jtopk.top_k(a, 3), lambda a: ttopk.top_k(a, 3), [x],
           wrt=(0,))
    parity(jtopk.max_id, ttopk.max_id, [x])


def test_topk_ties_go_to_the_lower_index():
    x = np.asarray([[1, 3, 3, 0, 3, 1], [2, 2, 2, 2, 2, 2],
                    [0, 5, 1, 5, 1, 5]], np.float32)
    t, j = parity(lambda a: jtopk.top_k(a, 4), lambda a: ttopk.top_k(a, 4),
                  [x])
    np.testing.assert_array_equal(t[1].numpy(), [[1, 2, 4, 0], [0, 1, 2, 3],
                                                 [1, 3, 5, 2]])


def test_max_id_nan_and_tie_rows():
    x = np.asarray([[1, np.nan, 3, np.nan], [4, 4, 1, 0],
                    [-np.inf, -np.inf, -np.inf, -np.inf]], np.float32)
    t, _ = parity(jtopk.max_id, ttopk.max_id, [x])
    np.testing.assert_array_equal(t.numpy()[:, 0], [1, 0, 0])


def _labels(rng, n, c):
    return rng.randint(0, c, n).astype(np.int32)


def test_softmax_cross_entropy(rng):
    labels = _labels(rng, 6, 5)
    parity(lambda a: jloss.softmax_cross_entropy(a, to_j(labels)),
           lambda a: tloss.softmax_cross_entropy(a, to_t(labels)),
           [_x(rng, 6, 5)], wrt=(0,))


def test_soft_cross_entropy(rng):
    p = np.abs(_x(rng, 4, 5))
    p = p / p.sum(-1, keepdims=True)
    parity(jloss.soft_cross_entropy, tloss.soft_cross_entropy,
           [_x(rng, 4, 5), p], wrt=(0, 1))


def test_cross_entropy_with_probs(rng):
    logits = _x(rng, 4, 3)
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    labels = np.array([0, 2, 1, 1], np.int32)
    parity(lambda a: jloss.cross_entropy_with_probs(a, to_j(labels)),
           lambda a: tloss.cross_entropy_with_probs(a, to_t(labels)), [p],
           wrt=(0,))


def test_square_error(rng):
    parity(jloss.square_error, tloss.square_error,
           [_x(rng, 3, 4), _x(rng, 3, 4)], wrt=(0, 1))
    parity(jloss.square_error, tloss.square_error,
           [_x(rng, 3, 2, 2), _x(rng, 3, 2, 2)], wrt=(0,))


def test_smooth_l1_and_huber_regression(rng):
    a, b = _x(rng, 4, 3, scale=2.0), _x(rng, 4, 3, scale=2.0)
    parity(jloss.smooth_l1, tloss.smooth_l1, [a, b], wrt=(0, 1))
    parity(lambda p, q: jloss.smooth_l1(p, q, 0.5),
           lambda p, q: tloss.smooth_l1(p, q, 0.5), [a, b], wrt=(0,))
    parity(jloss.huber_regression, tloss.huber_regression, [a, b],
           wrt=(0, 1))


def test_bce_and_multibinary(rng):
    p = (rng.rand(4, 3) * 0.9 + 0.05).astype(np.float32)
    y = (rng.rand(4, 3) > 0.5).astype(np.float32)
    parity(jloss.binary_cross_entropy, tloss.binary_cross_entropy, [p, y],
           wrt=(0,))
    parity(jloss.multi_binary_cross_entropy, tloss.multi_binary_cross_entropy,
           [p, y], wrt=(0,))


def test_rank_cost(rng):
    y = (rng.rand(5) > 0.5).astype(np.float32)
    parity(jloss.rank_cost, tloss.rank_cost,
           [_x(rng, 5, 1), _x(rng, 5, 1), y], wrt=(0, 1))


def test_huber_hinge(rng):
    pred = _x(rng, 6, 1, scale=2.0)
    lab = (rng.rand(6) > 0.5).astype(np.float32)
    parity(jloss.huber_classification, tloss.huber_classification,
           [pred, lab], wrt=(0,))
    parity(jloss.hinge, tloss.hinge, [pred, lab], wrt=(0,))


def test_cross_entropy_with_selfnorm(rng):
    labels = _labels(rng, 5, 7)
    parity(lambda a: jloss.cross_entropy_with_selfnorm(a, to_j(labels), 0.3),
           lambda a: tloss.cross_entropy_with_selfnorm(a, to_t(labels), 0.3),
           [_x(rng, 5, 7, scale=2.0)], wrt=(0,))


def test_lambda_rank(rng):
    """Ragged lists; tied scores and tied relevances rank the lower index
    first in both (stable sorts)."""
    scores = _x(rng, 4, 9)
    scores[0, 2] = scores[0, 5]                   # a score tie
    scores[1, :] = 0.5                            # a list of ties
    rel = rng.randint(0, 4, (4, 9)).astype(np.float32)
    lengths = np.array([9, 6, 1, 4], np.int32)
    for k in (5, 2):
        parity(lambda s, r: jloss.lambda_rank(s, r, to_j(lengths), k),
               lambda s, r: tloss.lambda_rank(s, r, to_t(lengths), k),
               [scores, rel], wrt=(0,))


@pytest.fixture
def bf16_compute():
    old = (JFLAGS.get("compute_dtype"), TFLAGS.get("compute_dtype"))
    JFLAGS.set("compute_dtype", "bfloat16")
    TFLAGS.set("compute_dtype", "bfloat16")
    yield
    JFLAGS.set("compute_dtype", old[0])
    TFLAGS.set("compute_dtype", old[1])


def test_matmul_bf16_grad(bf16_compute, rng):
    """bf16 operands, fp32 accumulation, fp32 result and fp32 gradients,
    within 2 bf16 ulps of the JAX package's."""
    a, b = _x(rng, 8, 16), _x(rng, 16, 4)
    jo = jmath.matmul(to_j(a), to_j(b))
    at, bt = to_t(a, True), to_t(b, True)
    to = tmath.matmul(at, bt)
    assert to.dtype == torch.float32
    assert bf16_ulp_err(to, jo) <= 2
    jg = jax.grad(lambda x, y: jmath.matmul(x, y).sum(), argnums=(0, 1))(
        to_j(a), to_j(b))
    tg = torch.autograd.grad(to.sum(), (at, bt))
    for g, e in zip(tg, jg):
        assert g.dtype == torch.float32
        assert bf16_ulp_err(g, e) <= 2
    np.testing.assert_allclose(to.detach().numpy(), a @ b, rtol=5e-2,
                               atol=5e-2)
