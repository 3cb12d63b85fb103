"""The port's ``trainer.SGD`` against ``paddle_tpu``'s on the CPU.

The cases of ``tests/test_trainer_mnist.py`` on synthetic MNIST-shaped
rows (a LeNet with dropout, Momentum, a classification-error evaluator),
the JAX package's parameters carried into the port through
``Parameters.to_tar``, the same rows and ``init(seed=...)`` on both sides:
per-step costs and final parameters within 1e-4 (of max(1, max|JAX
value|); fp32 compute on both sides, as ``tests/conftest.py`` sets it),
evaluator results equal; the microbatched step (``grad_accum_steps``)
against JAX's and against the port's plain step; the ragged tail, the
one-batch lookahead, the events, ``test``, ``save_parameter_to_tar``
loaded by the JAX package, the path that raises until ROADMAP A10b and
the ``parallel=`` path that no longer does.
``test_checkpoint_roundtrip`` and the checkpoint and pipeline paths are
in ``tests/test_torch_trainer_resume.py``.
"""


import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.trainer  # noqa: F401
import paddle_tpu_torch as T
import paddle_tpu_torch.trainer  # noqa: F401
from paddle_tpu.utils.rng import KeySource as JKeySource
from tests.torch_layers_util import (carry, global_seed_kept,  # noqa: F401
                                    keep_global_seed)
from tests.torch_ops_util import scaled_err

pytestmark = pytest.mark.usefixtures("keep_global_seed")

TOL = 1e-4


def _lenet(P, dropout=True):
    """The reference test's LeNet (narrower) with a dropout layer, its
    cost and error evaluator, built with ``P`` (either package)."""
    L, A = P.layer, P.activation
    img = L.data("pixel", P.data_type.dense_vector(784))
    lbl = L.data("label", P.data_type.integer_value(10))
    c1 = P.networks.simple_img_conv_pool(img, filter_size=5, num_filters=4,
                                         pool_size=2, num_channel=1,
                                         act=A.Relu(), name="c1")
    c2 = P.networks.simple_img_conv_pool(c1, filter_size=5, num_filters=8,
                                         pool_size=2, act=A.Relu(),
                                         name="c2")
    h = L.fc(c2, 32, act=A.Relu(), name="fc1")
    if dropout:
        h = L.dropout(h, 0.3, name="drop")
    pred = L.fc(h, 10, act=A.Softmax(), name="pred")
    cost = L.classification_cost(pred, lbl, name="cost")
    err = P.evaluator.classification_error(pred, lbl, name="err")
    return pred, cost, err


def _mnist_rows(n, seed):
    """Learnable MNIST-shaped rows: the label is the argmax of a fixed
    projection of the image."""
    rng = np.random.RandomState(seed)
    proj = np.random.RandomState(99).randn(784, 10).astype(np.float32)
    x = rng.rand(n, 784).astype(np.float32)
    y = np.argmax((x - 0.5) @ proj, axis=1)
    return [(x[i], int(y[i])) for i in range(n)]


def _costs(P, out):
    return lambda e: out.append(e.cost) if isinstance(
        e, P.event.EndIteration) else None


def _pair(builder, seed=3, **sgd):
    """(JAX trainer, port trainer, builder outputs) over one graph, the
    JAX package's parameters carried into the port."""
    jo, to = builder(J), builder(T)
    jcost, tcost = jo[1], to[1]
    jextra, textra = list(jo[2:]), list(to[2:])
    jp = J.parameters.create(J.topology.Topology([jcost] + jextra),
                             JKeySource(seed))
    tp = carry(jp, T.topology.Topology([tcost] + textra))
    opt = sgd.pop("opt", lambda P: P.optimizer.Momentum(momentum=0.9,
                                                        learning_rate=0.05))
    jt = J.trainer.SGD(jcost, jp, opt(J), extra_layers=jextra, **sgd)
    tt = T.trainer.SGD(tcost, tp, opt(T), extra_layers=textra, **sgd)
    return jt, tt, jo, to


def _train_both(jt, tt, rows, batch, passes=1, seed=1234, feeding=None,
                drop_last=True):
    J.init(seed=seed)
    T.init(seed=seed)
    jl, tl = [], []
    jt.train(J.batch(lambda: iter(rows), batch, drop_last), passes,
             _costs(J, jl), feeding=feeding)
    tt.train(T.batch(lambda: iter(rows), batch, drop_last), passes,
             _costs(T, tl), feeding=feeding)
    return jl, tl


def _assert_params(jp, tp, tol=TOL):
    assert set(jp.values) == set(tp.values)
    for k in jp.values:
        err = scaled_err(tp.values[k], jp.values[k])
        assert err <= tol, f"{k}: {err}"
    for k in jp.state:
        assert scaled_err(tp.state[k], jp.state[k]) <= tol, k


@pytest.fixture(scope="module")
def trained():
    jt, tt, jo, to = _pair(_lenet)
    ptrs = {k: v.data_ptr() for k, v in tt.parameters.values.items()}
    rows = _mnist_rows(192, 0)
    with global_seed_kept():
        jl, tl = _train_both(jt, tt, rows, 32, passes=2)
    return jt, tt, jo, to, ptrs, jl, tl, rows


def test_training_matches_jax(trained):
    jt, tt, jo, to, _, jl, tl, rows = trained
    assert len(jl) == len(tl) == 12
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    _assert_params(jt.parameters, tt.parameters)
    assert tt.evaluators.result() == jt.evaluators.result()
    assert tt._step == jt._step == 12


def test_training_converges(trained):
    *_, jl, tl, rows = trained
    assert np.mean(tl[-3:]) < np.mean(tl[:3]), tl


def test_test_sweep_matches_jax(trained):
    jt, tt, *_ = trained
    rows = _mnist_rows(64, 1)
    jr = jt.test(J.batch(lambda: iter(rows), 32))
    tr = tt.test(T.batch(lambda: iter(rows), 32))
    assert abs(tr.cost - jr.cost) <= TOL
    assert tr.metrics == jr.metrics


def test_infer_matches_training(trained):
    jt, tt, jo, to, *_ = trained
    samples = [(x,) for x, _ in _mnist_rows(32, 2)]
    jprobs = J.infer(output_layer=jo[0], parameters=jt.parameters,
                     input=samples)
    tprobs = T.infer(output_layer=to[0], parameters=tt.parameters,
                     input=samples)
    assert tprobs.shape == (32, 10)
    assert scaled_err(tprobs, jprobs) <= TOL


def test_params_tar_roundtrip_and_jax_load(trained, tmp_path):
    jt, tt, jo, to, ptrs, *_ = trained
    f = tmp_path / "params.tar"
    with open(f, "wb") as fh:
        tt.save_parameter_to_tar(fh)
    with open(f, "rb") as fh:
        back = T.parameters.Parameters.from_tar(fh, device="cpu")
    with open(f, "rb") as fh:
        jback = J.parameters.Parameters.from_tar(fh)
    for k, v in tt.parameters.values.items():
        np.testing.assert_array_equal(back[k], v.numpy())
        np.testing.assert_array_equal(np.asarray(jback[k]), v.numpy())
    # the tensors the trainer wrote are the ones it was built with, updated
    # in place by every step (the same storage before and after training)
    assert {k: v.data_ptr() for k, v in tt.parameters.values.items()} == ptrs
    assert all(not v.requires_grad for v in tt.parameters.values.values())


def test_evaluator_counts_follow_the_steps(trained):
    jt, tt, *_ = trained
    assert 0.0 <= tt.evaluators.result()["err"] <= 1.0


class TestGradAccum:
    def _bn_net(self, P):
        L, A = P.layer, P.activation
        x = L.data("ga_x", P.data_type.dense_vector(20))
        y = L.data("ga_y", P.data_type.integer_value(5))
        h = L.fc(x, 16, act=None, name="ga_h")
        h = L.batch_norm(h, act=A.Relu(), name="ga_bn")
        h = L.dropout(h, 0.2, name="ga_drop")
        out = L.fc(h, 5, act=A.Softmax(), name="ga_o")
        return out, L.classification_cost(out, y, name="ga_c"), \
            P.evaluator.classification_error(out, y, name="ga_err")

    def _plain_net(self, P):
        L, A = P.layer, P.activation
        x = L.data("ga_x", P.data_type.dense_vector(20))
        y = L.data("ga_y", P.data_type.integer_value(5))
        h = L.fc(x, 16, act=A.Relu(), name="ga_h")
        out = L.fc(h, 5, act=A.Softmax(), name="ga_o")
        return out, L.classification_cost(out, y, name="ga_c")

    def _rows(self, n, seed=9):
        rng = np.random.RandomState(seed)
        return [(rng.randn(20).astype(np.float32), int(rng.randint(5)))
                for _ in range(n)]

    def test_accum_matches_jax_with_bn_and_dropout(self):
        """grad_accum_steps=2 against JAX's accumulated step: ghost-BN
        statistics threaded slice by slice, one dropout key per slice
        (``prng.split`` of the step key), metric accumulables summed."""
        jt, tt, *_ = _pair(self._bn_net, seed=123, grad_accum_steps=2)
        jl, tl = _train_both(jt, tt, self._rows(128), 32)
        assert len(tl) == 4
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
        _assert_params(jt.parameters, tt.parameters)
        assert tt.evaluators.result() == jt.evaluators.result()

    def test_accum_matches_plain(self):
        """grad_accum_steps=4 reproduces the plain step on a BN-free,
        dropout-free model (the optimizer sees the same full-batch mean
        gradient; only summation order differs)."""
        runs = []
        for accum in (1, 4):
            _, tt, *_ = _pair(self._plain_net, seed=123,
                              grad_accum_steps=accum)
            T.init(seed=1)
            losses = []
            tt.train(T.batch(lambda: iter(self._rows(192)), 32),
                     event_handler=_costs(T, losses))
            runs.append((losses, tt.parameters))
        np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=2e-4,
                                   atol=2e-5)
        for k, v in runs[0][1].values.items():
            np.testing.assert_allclose(runs[1][1].values[k].numpy(),
                                       v.numpy(), rtol=2e-4, atol=2e-5)

    def test_invalid_steps_rejected(self):
        with pytest.raises(ValueError, match="grad_accum_steps"):
            _pair(self._plain_net, grad_accum_steps=0)

    def test_ragged_tail_falls_back_to_plain_step(self):
        """drop_last=False remainder batches route to the unaccumulated
        step, as in the JAX package (its costs equal JAX's)."""
        jt, tt, *_ = _pair(self._plain_net, seed=5, grad_accum_steps=4,
                           opt=lambda P: P.optimizer.SGD(learning_rate=0.1))
        jl, tl = _train_both(jt, tt, self._rows(90, seed=2), 32,
                             drop_last=False)
        assert len(tl) == 3                  # 32 + 32 + 26
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
        _assert_params(jt.parameters, tt.parameters)


class TestPrefetchFeeds:
    """The feed pipeline runs one batch AHEAD of consumption."""

    def test_one_batch_lookahead_order(self):
        log = []

        class SpyFeeder:
            def feed(self, b):
                log.append(("feed", b))
                return {"x": b}

        sgd = object.__new__(T.trainer.SGD)
        for got in sgd._prefetch_feeds(lambda: iter(range(3)), SpyFeeder()):
            log.append(("consume", got["x"]))
        assert log == [("feed", 0), ("feed", 1), ("consume", 0),
                       ("feed", 2), ("consume", 1), ("consume", 2)]

    def test_empty_reader_yields_nothing(self):
        class F:
            def feed(self, b):           # pragma: no cover
                raise AssertionError("must not be called")

        sgd = object.__new__(T.trainer.SGD)
        assert list(sgd._prefetch_feeds(lambda: iter([]), F())) == []

    def test_empty_reader_trains_nothing(self):
        _, tt, *_ = _pair(TestGradAccum()._plain_net)
        events = []
        tt.train(lambda: iter([]), num_passes=1,
                 event_handler=lambda e: events.append(type(e).__name__))
        assert events == ["BeginPass", "EndPass"]
        assert tt._step == 0


def test_events_order_matches_jax():
    net = TestGradAccum()._plain_net
    jt, tt, *_ = _pair(net)
    rows = TestGradAccum()._rows(64)
    names = []
    for P, tr in ((J, jt), (T, tt)):
        ev = []
        P.init(seed=3)
        tr.train(P.batch(lambda: iter(rows), 32), num_passes=2,
                 event_handler=lambda e: ev.append(
                     (type(e).__name__, getattr(e, "pass_id", None),
                      getattr(e, "batch_id", None))))
        names.append(ev)
    assert names[1] == names[0]
    assert names[1][:3] == [("BeginPass", 0, None),
                            ("BeginIteration", 0, 0),
                            ("EndIteration", 0, 0)]


class TestPendingPaths:
    """Paths that need modules still to port raise, naming the item; the
    A8 paths that raised before the input pipeline and checkpoints were
    ported now run (kept under their names)."""

    def _trainer(self):
        return _pair(TestGradAccum()._plain_net)[1]

    def test_parallel_raises_a9(self):
        """Ported (the name is kept): ``parallel=`` trains over a mesh of
        gloo ranks; data parallelism over 4 ranks follows the port's
        single-device trajectory (the parity with the JAX package is
        ``tests/test_torch_spmd.py``)."""
        from tests import torch_dist_cases as cases
        from tests.torch_dist_util import pool
        jp = J.parameters.create(cases.mlp(J), JKeySource(11))
        rng = np.random.RandomState(0)
        x = rng.randn(32, 8).astype(np.float32)
        y = rng.randint(3, size=32).astype(np.int64)
        inp = {"x": x, "y": y,
               **{f"p/{k}": np.asarray(v) for k, v in jp.values.items()}}
        single, dp = (pool().run("case_train", inputs=inp, net="mlp",
                                 mesh_shape=shape)[0]["costs"]
                      for shape in (None, (4,)))
        np.testing.assert_allclose(dp, single, rtol=1e-5)

    def test_checkpoint_dir_raises_a8(self, tmp_path):
        """Ported: an empty pass with a checkpoint dir writes the pass's
        checkpoint (step 0) instead of raising."""
        tr = self._trainer()
        tr.train(lambda: iter([]), checkpoint_dir=str(tmp_path))
        from paddle_tpu_torch.io import checkpoint as ck
        assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt-00000000")

    def test_prefetch_raises_a8(self):
        """Ported: ``prefetch=2`` feeds through the input pipeline."""
        events = []
        self._trainer().train(lambda: iter([]), prefetch=2,
                              event_handler=lambda e: events.append(
                                  type(e).__name__))
        assert events == ["BeginPass", "EndPass"]

    def test_elastic_contract_raises_a9(self, monkeypatch, tmp_path):
        """The elastic supervisor contract is ROADMAP A10b now."""
        monkeypatch.setenv("PADDLE_ELASTIC_DIR", str(tmp_path))
        with pytest.raises(NotImplementedError, match="A10b"):
            self._trainer().train(lambda: iter([]))


def test_feeds_go_to_the_parameters_device():
    tt = _pair(TestGradAccum()._plain_net)[1]
    assert tt.device == torch.device("cpu")
    assert tt._feeder(None).device == torch.device("cpu")
    feeds = tt._feeder(None).feed(TestGradAccum()._rows(4))
    assert all(v.array.device.type == "cpu" for v in feeds.values())


def test_flop_count_leaves_no_trace():
    """The MFU numerator's forward + backward under the FLOP counter
    touches no parameter, ``.grad``, optimizer or model state, and no
    compile-tracker count."""
    jt, tt, *_ = _pair(TestGradAccum()._bn_net)
    T.init(seed=2)
    tt.train(T.batch(lambda: iter(TestGradAccum()._rows(32)), 16))
    before = ({k: v.clone() for k, v in tt.parameters.values.items()},
              {k: v.clone() for k, v in tt.parameters.state.items()},
              {k: [x.clone() for x in s] for k, s in tt.opt_state.items()})
    n = T.observe.default_compile_tracker().count("train_step")
    feeds = tt._feeder(None).feed(TestGradAccum()._rows(16))
    flops = tt.count_step_flops(feeds, T.ops.prng.prng_key(0))
    # fc 20->16 and 16->5 over 16 rows, forward and backward (input and
    # weight gradients of the second fc, the first's weight gradient)
    fwd = 2 * 16 * (20 * 16 + 16 * 5)
    assert flops == fwd + 2 * 16 * (16 * 5) * 2 + 2 * 16 * 20 * 16
    for k, v in tt.parameters.values.items():
        assert torch.equal(v, before[0][k]) and v.grad is None
    for k, v in tt.parameters.state.items():
        assert torch.equal(v, before[1][k])
    for k, s in tt.opt_state.items():
        assert all(torch.equal(a, b) for a, b in zip(s, before[2][k]))
    assert T.observe.default_compile_tracker().count("train_step") == n


def test_nan_tripwire_raises_under_debug_nans(monkeypatch, tmp_path):
    """``init(debug_nans=True)`` arms the tripwire: a NaN cost raises
    (here the NaN inputs also poisoned the updated parameters, which the
    check names) and leaves a flight-recorder post-mortem."""
    from paddle_tpu_torch.utils import enforce
    from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    _, tt, *_ = _pair(TestGradAccum()._plain_net)
    rows = [(np.full(20, np.nan, np.float32), 1)] * 8
    T.init(debug_nans=True)
    try:
        with pytest.raises(enforce.EnforceError, match="non-finite"):
            tt.train(T.batch(lambda: iter(rows), 8))
    finally:
        GLOBAL_FLAGS.set("debug_nans", False)
    assert list(tmp_path.glob("flight_*.json"))
