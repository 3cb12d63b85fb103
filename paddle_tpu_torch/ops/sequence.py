"""Sequence ops over padded + masked batches (counterpart of
``paddle_tpu/ops/sequence.py``).

Inputs are [batch, time, ...] + lengths [batch] (see ``core.ragged``);
masked dense ops replace the reference's start-position indexing.
"""

import torch

from paddle_tpu_torch.ops.topk import top_k

NEG_INF = -1e30


def _mask(lengths, max_len, dtype=torch.float32):
    t = torch.arange(max_len, dtype=torch.int32, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def _bcast(m, x):
    """[b, t] mask shaped to broadcast over x's trailing dims."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def seq_sum(x, lengths):
    """[b,t,...] -> [b,...] sum over valid steps."""
    return (x * _bcast(_mask(lengths, x.shape[1]), x).to(x.dtype)).sum(dim=1)


def seq_avg(x, lengths):
    denom = torch.clamp_min(lengths, 1).to(x.dtype)
    return seq_sum(x, lengths) / denom.reshape((-1,) + (1,) * (x.dim() - 2))


def seq_sqrt(x, lengths):
    """sum / sqrt(len)."""
    denom = torch.sqrt(torch.clamp_min(lengths, 1).to(x.dtype))
    return seq_sum(x, lengths) / denom.reshape((-1,) + (1,) * (x.dim() - 2))


def seq_max(x, lengths):
    m = _bcast(_mask(lengths, x.shape[1], torch.bool), x)
    return torch.where(m, x, NEG_INF).amax(dim=1)


def seq_last(x, lengths):
    """Last valid step."""
    idx = torch.clamp_min(lengths - 1, 0).long()
    return x[torch.arange(x.shape[0], device=x.device), idx]


def seq_first(x, lengths):
    return x[:, 0]


def seq_softmax(x, lengths):
    """Softmax over the time axis per sequence, padding masked out."""
    m = _mask(lengths, x.shape[1], torch.bool)
    while m.dim() < x.dim():
        m = m[..., None]
    logits = torch.where(m, x.float(), NEG_INF)
    out = torch.softmax(logits, dim=1)
    return torch.where(m, out, 0.0).to(x.dtype)


def seq_expand(x, lengths, max_len: int):
    """Broadcast one vector per sequence across its timesteps:
    [b, d] -> [b, t, d] masked."""
    out = x[:, None].expand((x.shape[0], max_len) + tuple(x.shape[1:]))
    return out * _mask(lengths, max_len, x.dtype).reshape(
        x.shape[0], max_len, *([1] * (x.dim() - 1)))


def _gather_t(x, idx):
    """x[b, idx[b, t], ...] (take_along_axis on the time axis)."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2])
                                         + tuple(x.shape[2:])))


def seq_reverse(x, lengths):
    """Reverse each sequence within its valid region."""
    t = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    idx = torch.where(t[None, :] < lengths[:, None],
                      lengths[:, None] - 1 - t[None, :], t[None, :])
    return _gather_t(x, idx)


def context_projection(x, lengths, context_len: int, context_start: int):
    """Sliding context-window concat: out[:, t] = concat(x[:, t+start],
    ..., x[:, t+start+len-1]) with out-of-sequence positions zero."""
    b, tmax, d = x.shape
    xm = x * _mask(lengths, tmax, x.dtype)[..., None]
    t = torch.arange(tmax, device=x.device)
    cols = []
    for k in range(context_len):
        shift = context_start + k
        rolled = torch.roll(xm, -shift, dims=1)
        valid = ((t[None, :] + shift >= 0)
                 & (t[None, :] + shift < lengths[:, None]))
        cols.append(torch.where(valid[..., None], rolled, 0.0))
    return torch.cat(cols, dim=-1)


def row_conv(x, lengths, w):
    """Lookahead row convolution: out[:, t] = sum_k x[:, t+k] * w[k]."""
    k = w.shape[0]
    ctx = context_projection(x, lengths, k, 0)              # [b, t, k*d]
    b, tmax, _ = x.shape
    ctx = ctx.reshape(b, tmax, k, -1)
    return torch.einsum("btkd,kd->btd", ctx, w.to(x.dtype))


def kmax_score_indices(scores, lengths, k: int):
    """Top-k step indices per sequence by score (ties to the lower
    step). scores: [b, t]. Returns [b, k] indices."""
    masked = torch.where(_mask(lengths, scores.shape[1], torch.bool),
                         scores, NEG_INF)
    return top_k(masked, k)[1]


def seq_concat(x, x_len, y, y_len):
    """Per-sequence time-axis concat, padded to x.max_len + y.max_len."""
    b, tx, d = x.shape
    ty = y.shape[1]
    t = torch.arange(tx + ty, dtype=torch.int32, device=x.device)
    from_x = t[None, :] < x_len[:, None]
    y_idx = torch.clamp(t[None, :] - x_len[:, None], 0, ty - 1)
    x_idx = torch.clamp(t[None, :], 0, tx - 1).expand(b, tx + ty)
    out = torch.where(from_x[..., None], _gather_t(x, x_idx),
                      _gather_t(y, y_idx))
    valid = t[None, :] < (x_len + y_len)[:, None]
    return torch.where(valid[..., None], out, 0.0), x_len + y_len


def sub_nested_seq(x, sub_lengths, sel_idx, sel_count):
    """Select sub-sequences from a nested (2-level) sequence batch, in
    selection order.

    x: [b, T, ...] sub-sequences concatenated on the time axis;
    sub_lengths: [b, S] per-sub-sequence lengths (0-padded);
    sel_idx: [b, K] selected sub-sequence indices (entries past
    sel_count[b] ignored); sel_count: [b].
    Returns (out [b, T, ...], new_lengths [b], new_sub_lengths [b, K]).
    A selection index outside [0, S) or pointing at a 0-length slot
    contributes an empty sub-sequence; duplicate selections past the T
    bound truncate, and the returned lengths agree with the truncation.
    """
    b, t_max = x.shape[0], x.shape[1]
    s = sub_lengths.shape[1]
    k = sel_idx.shape[1]
    i32 = torch.int32
    dev = x.device
    sel_idx = sel_idx.to(i32)
    sub_lengths = sub_lengths.to(i32)
    k_valid = ((torch.arange(k, dtype=i32, device=dev)[None, :]
                < sel_count[:, None]) & (sel_idx >= 0) & (sel_idx < s))
    sidx = torch.clamp(sel_idx, 0, s - 1).long()
    sel_lens = torch.where(k_valid, torch.gather(sub_lengths, 1, sidx), 0)
    sub_starts = torch.cat(
        [torch.zeros((b, 1), dtype=i32, device=dev),
         torch.cumsum(sub_lengths, dim=1, dtype=i32)[:, :-1]], dim=1)
    src_starts = torch.gather(sub_starts, 1, sidx)                 # [b,K]
    out_ends = torch.cumsum(sel_lens, dim=1, dtype=i32)            # [b,K]
    out_starts = out_ends - sel_lens
    new_lengths = torch.clamp_max(out_ends[:, -1], t_max)
    sel_lens = (torch.clamp_max(out_ends, t_max)
                - torch.clamp_max(out_starts, t_max))
    t = torch.arange(t_max, dtype=i32, device=dev)
    in_chunk = ((t[None, :, None] >= out_starts[:, None, :])
                & (t[None, :, None] < out_ends[:, None, :]))        # [b,T,K]
    chunk = in_chunk.to(i32).argmax(dim=2)                         # [b,T]
    valid = in_chunk.any(dim=2)                                    # [b,T]
    off = t[None, :] - torch.gather(out_starts, 1, chunk)
    src = torch.clamp(torch.gather(src_starts, 1, chunk) + off, 0, t_max - 1)
    out = _gather_t(x, src)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    out = torch.where(_bcast(valid, x), out, zero)
    return out, new_lengths, sel_lens
