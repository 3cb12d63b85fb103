"""The port's recurrent cells and scans against ``paddle_tpu``'s on the
CPU.

Every case of ``tests/test_ops_rnn.py`` (LSTM against the numpy
recurrence, the reverse scan's state, LSTM gradients, GRU, the simple
RNN), held here against the JAX functions on the same seeded arrays, plus
the frozen state of finished rows (a row's outputs and final state do
not depend on its padded steps), initial states, ``forget_bias``,
biases, the cells alone, and the 2-D MDLSTM in all four directions.

Tolerances: fp32 forward 1e-5; gradients through the scans 1e-4 (of
max(1, max|JAX value|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import rnn as jrnn
from paddle_tpu_torch.ops import rnn as trnn
from tests.torch_ops_util import parity, to_j, to_t

torch.set_num_threads(1)


def _w(rng, *shape):
    return (rng.randn(*shape) * 0.3).astype(np.float32)


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def _np_lstm(x, lens, w_ih, w_hh, b):
    bsz, tmax, _ = x.shape
    H = w_hh.shape[0]
    h = np.zeros((bsz, H))
    c = np.zeros((bsz, H))
    outs = np.zeros((bsz, tmax, H))
    for t in range(tmax):
        gates = x[:, t] @ w_ih + h @ w_hh + b
        i, f, g, o = np.split(gates, 4, axis=-1)
        nc = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
        nh = _sigmoid(o) * np.tanh(nc)
        alive = (t < lens)[:, None]
        c = np.where(alive, nc, c)
        h = np.where(alive, nh, h)
        outs[:, t] = np.where(alive, nh, 0)
    return outs, h, c


def _lstm_args(rng, bsz, tmax, d, H, bias=True):
    return [rng.randn(bsz, tmax, d).astype(np.float32), _w(rng, d, 4 * H),
            _w(rng, H, 4 * H), _w(rng, 4 * H) if bias else None]


def test_lstm_matches_numpy(rng):
    lens = np.array([6, 3, 1], np.int32)
    x, w_ih, w_hh, b = _lstm_args(rng, 3, 6, 5, 4)
    t, _ = parity(lambda *a: jrnn.lstm(a[0], to_j(lens), *a[1:]),
                  lambda *a: trnn.lstm(a[0], to_t(lens), *a[1:]),
                  [x, w_ih, w_hh, b], wrt=(0, 1, 2, 3))
    ref_o, ref_h, ref_c = _np_lstm(x, lens, w_ih, w_hh, b)
    np.testing.assert_allclose(t[0].detach().numpy(), ref_o, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t[1].h.detach().numpy(), ref_h, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t[1].c.detach().numpy(), ref_c, rtol=1e-4,
                               atol=1e-5)


def test_lstm_reverse_state_is_first_step(rng):
    lens = np.array([4, 2], np.int32)
    x, w_ih, w_hh, _ = _lstm_args(rng, 2, 5, 3, 4)
    t, _ = parity(
        lambda *a: jrnn.lstm(a[0], to_j(lens), *a[1:], None, reverse=True),
        lambda *a: trnn.lstm(a[0], to_t(lens), *a[1:], None, reverse=True),
        [x, w_ih, w_hh], wrt=(0, 1, 2))
    outs = t[0].detach().numpy()
    np.testing.assert_allclose(outs[0, 0], t[1].h.detach().numpy()[0],
                               rtol=1e-5)
    assert np.abs(outs[1, 2:]).max() == 0


def test_lstm_grad(rng):
    lens = np.array([3, 2], np.int32)
    x, w_ih, w_hh, _ = _lstm_args(rng, 2, 3, 3, 2)
    parity(lambda *a: jrnn.lstm(a[0], to_j(lens), a[1], a[2], None)[0],
           lambda *a: trnn.lstm(a[0], to_t(lens), a[1], a[2], None)[0],
           [x, w_ih, w_hh], wrt=(0, 1, 2))


def test_lstm_initial_state_and_forget_bias(rng):
    lens = np.array([5, 0, 3], np.int32)
    x, w_ih, w_hh, b = _lstm_args(rng, 3, 5, 4, 3)
    h0, c0 = _w(rng, 3, 3), _w(rng, 3, 3)
    kw = dict(forget_bias=1.0)
    for reverse in (False, True):
        parity(lambda *a: jrnn.lstm(a[0], to_j(lens), a[1], a[2], a[3],
                                    h0=a[4], c0=a[5], reverse=reverse, **kw),
               lambda *a: trnn.lstm(a[0], to_t(lens), a[1], a[2], a[3],
                                    h0=a[4], c0=a[5], reverse=reverse, **kw),
               [x, w_ih, w_hh, b, h0, c0], wrt=(0, 2, 4, 5))


@pytest.mark.parametrize("kind", ["lstm", "gru", "simple"])
@pytest.mark.parametrize("reverse", [False, True])
def test_frozen_rows_ignore_padding(rng, kind, reverse):
    """A finished row's outputs and final state are those of its valid
    prefix, whatever the padded steps hold; its padded outputs are 0."""
    lens = np.array([6, 2, 4], np.int32)
    x = rng.randn(3, 6, 4).astype(np.float32)
    H = 3
    gates = {"lstm": 4, "gru": 3, "simple": 1}[kind]
    w_ih, w_hh, b = _w(rng, 4, gates * H), _w(rng, H, gates * H), \
        _w(rng, gates * H)
    fn = {"lstm": trnn.lstm, "gru": trnn.gru, "simple": trnn.simple_rnn}[kind]
    jfn = {"lstm": jrnn.lstm, "gru": jrnn.gru, "simple": jrnn.simple_rnn}[kind]
    x2 = x.copy()
    for i, n in enumerate(lens):
        x2[i, n:] = 100.0
    outs = []
    for xx in (x, x2):
        t, _ = parity(lambda a: jfn(a, to_j(lens), to_j(w_ih), to_j(w_hh),
                                    to_j(b), reverse=reverse),
                      lambda a: fn(a, to_t(lens), to_t(w_ih), to_t(w_hh),
                                   to_t(b), reverse=reverse), [xx], wrt=(0,))
        outs.append(t)
    for a, e in zip(*(_numpy_outputs(o) for o in outs)):
        np.testing.assert_array_equal(a, e)
    o = outs[0][0].detach().numpy()
    for i, n in enumerate(lens):
        assert np.abs(o[i, n:]).max(initial=0.0) == 0.0


def _numpy_outputs(out):
    outs, final = out
    fin = list(final) if isinstance(final, tuple) else [final]
    return [outs.detach().numpy()] + [f.detach().numpy() for f in fin]


def _np_gru(x, lens, w_ih, w_hh):
    bsz, tmax, _ = x.shape
    H = w_hh.shape[0]
    h = np.zeros((bsz, H))
    outs = np.zeros((bsz, tmax, H))
    for t in range(tmax):
        xr, xu, xc = np.split(x[:, t] @ w_ih, 3, axis=-1)
        r = _sigmoid(xr + h @ w_hh[:, :H])
        u = _sigmoid(xu + h @ w_hh[:, H:2 * H])
        c = np.tanh(xc + (r * h) @ w_hh[:, 2 * H:])
        nh = u * h + (1 - u) * c
        alive = (t < lens)[:, None]
        h = np.where(alive, nh, h)
        outs[:, t] = np.where(alive, nh, 0)
    return outs, h


def test_gru_matches_numpy(rng):
    lens = np.array([4, 2], np.int32)
    x = rng.randn(2, 4, 3).astype(np.float32)
    w_ih, w_hh = _w(rng, 3, 15), _w(rng, 5, 15)
    t, _ = parity(lambda *a: jrnn.gru(a[0], to_j(lens), *a[1:]),
                  lambda *a: trnn.gru(a[0], to_t(lens), *a[1:]),
                  [x, w_ih, w_hh], wrt=(0, 1, 2))
    ref_o, ref_h = _np_gru(x, lens, w_ih, w_hh)
    np.testing.assert_allclose(t[0].detach().numpy(), ref_o, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t[1].detach().numpy(), ref_h, rtol=1e-4,
                               atol=1e-5)


def test_gru_bias_h0_reverse(rng):
    lens = np.array([5, 3, 5], np.int32)
    x = rng.randn(3, 5, 4).astype(np.float32)
    args = [x, _w(rng, 4, 9), _w(rng, 3, 9), _w(rng, 9), _w(rng, 3, 3)]
    parity(lambda *a: jrnn.gru(a[0], to_j(lens), *a[1:4], h0=a[4],
                               reverse=True),
           lambda *a: trnn.gru(a[0], to_t(lens), *a[1:4], h0=a[4],
                               reverse=True), args, wrt=(0, 1, 2, 3, 4))


def test_simple_rnn(rng):
    lens = np.array([3, 1], np.int32)
    x = rng.randn(2, 3, 4).astype(np.float32)
    w_ih, w_hh = _w(rng, 4, 3), _w(rng, 3, 3)
    t, _ = parity(lambda *a: jrnn.simple_rnn(a[0], to_j(lens), *a[1:]),
                  lambda *a: trnn.simple_rnn(a[0], to_t(lens), *a[1:]),
                  [x, w_ih, w_hh], wrt=(0, 1, 2))
    h = np.zeros((2, 3))
    for step in range(3):
        nh = np.tanh(x[:, step] @ w_ih + h @ w_hh)
        h = np.where((step < lens)[:, None], nh, h)
    np.testing.assert_allclose(t[1].detach().numpy(), h, rtol=1e-4,
                               atol=1e-5)


def test_simple_rnn_preprojected_with_bias(rng):
    """``w_ih=None``: the input is already at hidden size."""
    lens = np.array([4, 2], np.int32)
    parity(lambda x, w, b: jrnn.simple_rnn(x, to_j(lens), None, w, b,
                                           act=jnp.tanh, reverse=True),
           lambda x, w, b: trnn.simple_rnn(x, to_t(lens), None, w, b,
                                           act=torch.tanh, reverse=True),
           [rng.randn(2, 4, 3).astype(np.float32), _w(rng, 3, 3),
            _w(rng, 3)], wrt=(0, 1, 2))


def test_cells(rng):
    xp, h, c, w = _w(rng, 2, 12), _w(rng, 2, 3), _w(rng, 2, 3), _w(rng, 3, 12)
    parity(lambda *a: jrnn.lstm_cell(a[0], jrnn.LSTMState(a[1], a[2]), a[3],
                                     0.5),
           lambda *a: trnn.lstm_cell(a[0], trnn.LSTMState(a[1], a[2]), a[3],
                                     0.5), [xp, h, c, w], wrt=(0, 1, 2, 3))
    parity(jrnn.gru_cell, trnn.gru_cell, [_w(rng, 2, 9), h, _w(rng, 3, 9)],
           wrt=(0, 1, 2))


@pytest.mark.parametrize("reverse_x,reverse_y", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_mdlstm(rng, reverse_x, reverse_y):
    x = rng.randn(2, 3, 4, 3).astype(np.float32)
    args = [x, _w(rng, 3, 10), _w(rng, 2, 10), _w(rng, 2, 10), _w(rng, 10)]
    kw = dict(reverse_x=reverse_x, reverse_y=reverse_y)
    parity(lambda *a: jrnn.mdlstm(*a, **kw), lambda *a: trnn.mdlstm(*a, **kw),
           args, wrt=(0, 1, 2, 3, 4))
