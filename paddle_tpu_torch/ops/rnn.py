"""Recurrent cells and scans (counterpart of ``paddle_tpu/ops/rnn.py``).

One GEMM projects the inputs of every timestep up front (x @ W for all
gates, batched over time); then a Python loop over time, in place of
``lax.scan``, carries the state, each step one [batch, gates*hidden]
GEMM against the recurrent weights plus the gate math in fp32. The mask
freezes the state of finished rows. Each step is a handful of eager
launches on the card (see ``PERF.md``: the scans are launch-bound).

Gate order: (i, f, g, o) for LSTM, (r, u, c) for GRU, (i, f_x, f_y, g,
o) for MDLSTM, as in the JAX package.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.ops.math import matmul


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def _time_order(tmax: int, reverse: bool):
    return range(tmax - 1, -1, -1) if reverse else range(tmax)


def _scan(step, state, xs, mask, reverse):
    """Run ``step(state, x_t) -> (new state, h)`` over time (backwards if
    ``reverse``), keeping the old state of rows whose mask is false.
    xs: [b, t, ...]; mask: [b, t] bool. Returns (outputs [b, t, H] of the
    frozen states, masked, and the final state)."""
    outs = [None] * xs.shape[1]
    for t in _time_order(xs.shape[1], reverse):
        nxt = step(state, xs[:, t])
        mt = mask[:, t, None]
        if isinstance(state, tuple):
            state = type(state)(*(torch.where(mt, n, o)
                                  for n, o in zip(nxt, state)))
        else:
            state = torch.where(mt, nxt, state)
        outs[t] = state[0] if isinstance(state, tuple) else state
    out = torch.stack(outs, dim=1)
    return out * mask[..., None].to(out.dtype), state


def _project(x, w_ih, b, width):
    """The input projection of every timestep: one GEMM, + bias."""
    bsz, tmax, _ = x.shape
    xp = matmul(x.reshape(bsz * tmax, -1), w_ih).reshape(bsz, tmax, width)
    if b is not None:
        xp = xp + b.to(xp.dtype)
    return xp


def _lengths_mask(lengths, tmax):
    return (torch.arange(tmax, device=lengths.device)[None, :]
            < lengths[:, None])


def lstm_cell(x_proj: torch.Tensor, state: LSTMState, w_hh: torch.Tensor,
              forget_bias: float = 0.0) -> LSTMState:
    """One LSTM step. x_proj: [b, 4H] precomputed x@W_ih + b."""
    h, c = state
    gates = x_proj + matmul(h, w_hh)
    i, f, g, o = torch.chunk(gates.float(), 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    new_c = f * c.float() + i * g
    new_h = o * torch.tanh(new_c)
    return LSTMState(new_h.to(h.dtype), new_c.to(c.dtype))


def lstm(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
         w_hh: torch.Tensor, b: Optional[torch.Tensor] = None, *,
         reverse: bool = False, h0: Optional[torch.Tensor] = None,
         c0: Optional[torch.Tensor] = None, forget_bias: float = 0.0
         ) -> Tuple[torch.Tensor, LSTMState]:
    """Full-sequence LSTM. x: [b, t, d]; w_ih: [d, 4H]; w_hh: [H, 4H];
    b: [4H]. Returns (outputs [b, t, H], final LSTMState)."""
    bsz, tmax, _ = x.shape
    hidden = w_hh.shape[0]
    xp = _project(x, w_ih, b, 4 * hidden)
    zeros = torch.zeros((bsz, hidden), dtype=x.dtype, device=x.device)
    state = LSTMState(h0 if h0 is not None else zeros,
                      c0 if c0 is not None else zeros)
    return _scan(lambda s, xt: lstm_cell(xt, s, w_hh, forget_bias), state,
                 xp, _lengths_mask(lengths, tmax), reverse)


def gru_cell(x_proj: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor
             ) -> torch.Tensor:
    """One GRU step. x_proj: [b, 3H]; w_hh: [H, 3H] packed (r, u, c)."""
    hidden = h.shape[-1]
    hp = matmul(h, w_hh[:, : 2 * hidden])
    xr, xu, xc = torch.chunk(x_proj.float(), 3, dim=-1)
    hr, hu = torch.chunk(hp.float(), 2, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    hc = matmul(r * h.float(), w_hh[:, 2 * hidden:])
    c = torch.tanh(xc + hc.float())
    new_h = u * h.float() + (1 - u) * c
    return new_h.to(h.dtype)


def gru(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
        w_hh: torch.Tensor, b: Optional[torch.Tensor] = None, *,
        reverse: bool = False, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU. x: [b,t,d]; w_ih: [d,3H]; w_hh: [H,3H]."""
    bsz, tmax, _ = x.shape
    hidden = w_hh.shape[0]
    xp = _project(x, w_ih, b, 3 * hidden)
    h = h0 if h0 is not None else torch.zeros((bsz, hidden), dtype=x.dtype,
                                              device=x.device)
    return _scan(lambda s, xt: gru_cell(xt, s, w_hh), h, xp,
                 _lengths_mask(lengths, tmax), reverse)


def simple_rnn(x: torch.Tensor, lengths: torch.Tensor,
               w_ih: Optional[torch.Tensor], w_hh: torch.Tensor,
               b: Optional[torch.Tensor] = None, *, act=torch.tanh,
               reverse: bool = False, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla RNN. w_ih=None means the input is already projected to
    hidden size."""
    bsz, tmax, _ = x.shape
    hidden = w_hh.shape[0]
    if w_ih is None:
        xp = x if b is None else x + b.to(x.dtype)
    else:
        xp = _project(x, w_ih, b, hidden)
    h = h0 if h0 is not None else torch.zeros((bsz, hidden), dtype=x.dtype,
                                              device=x.device)

    def step(state, xt):
        return act((xt + matmul(state, w_hh)).float()).to(state.dtype)

    return _scan(step, h, xp, _lengths_mask(lengths, tmax), reverse)


class MDLSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def mdlstm_cell(x_proj: torch.Tensor, left: MDLSTMState, up: MDLSTMState,
                w_hx: torch.Tensor, w_hy: torch.Tensor) -> MDLSTMState:
    """One 2-D LSTM step: five gates (i, f_x, f_y, g, o), two
    predecessor states, each with its own forget gate:

        c = i*g + f_x*c_left + f_y*c_up;  h = o * tanh(c)

    x_proj: [b, 5H] precomputed x@W_ih (+bias)."""
    gates = x_proj + matmul(left.h, w_hx) + matmul(up.h, w_hy)
    i, fx, fy, g, o = torch.chunk(gates.float(), 5, dim=-1)
    i = torch.sigmoid(i)
    fx = torch.sigmoid(fx)
    fy = torch.sigmoid(fy)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = i * g + fx * left.c.float() + fy * up.c.float()
    h = o * torch.tanh(c)
    return MDLSTMState(h.to(left.h.dtype), c.to(left.c.dtype))


def mdlstm(x: torch.Tensor, w_ih: torch.Tensor, w_hx: torch.Tensor,
           w_hy: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           reverse_x: bool = False, reverse_y: bool = False
           ) -> torch.Tensor:
    """2-D multi-dimensional LSTM over a feature map.

    x: [N, H, W, C]; w_ih: [C, 5D]; w_hx/w_hy: [D, 5D] (left/up
    recurrent weights). Returns hidden maps [N, H, W, D]: cell (i, j)
    sees h[i][j-1] (left) and h[i-1][j] (up); reverse_x/_y flip the scan
    direction per dimension."""
    n, hh, ww, _ = x.shape
    d = w_hx.shape[0]
    xp = matmul(x.reshape(n * hh * ww, -1), w_ih).reshape(n, hh, ww, 5 * d)
    if b is not None:
        xp = xp + b.to(xp.dtype)
    zeros = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    up = [MDLSTMState(zeros, zeros)] * ww
    rows = [None] * hh
    for i in _time_order(hh, reverse_y):
        left = MDLSTMState(zeros, zeros)
        row = [None] * ww
        for j in _time_order(ww, reverse_x):
            left = mdlstm_cell(xp[:, i, j], left, up[j], w_hx, w_hy)
            row[j] = left
        up = row
        rows[i] = torch.stack([s.h for s in row], dim=1)     # [N, W, D]
    return torch.stack(rows, dim=1)
