"""CTC loss and best-path decoding (counterpart of
``paddle_tpu/ops/ctc.py``).

The loss is the log-space alpha recursion over the extended label
lattice [B, 2L+1], a Python loop over time of batched gathers and
three-way logaddexps, differentiated by autograd. "Minus infinity" is
``NEG_INF = -1e30``, as in the JAX package, so no step produces a NaN.
"""

import torch

NEG_INF = -1e30


def _extended_labels(labels: torch.Tensor, blank: int):
    """labels [B, L] -> lattice labels [B, 2L+1]: blank, l1, blank, ..."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _shift(a, k):
    """a moved k lattice positions right, NEG_INF shifted in."""
    return torch.nn.functional.pad(a, (k, 0), value=NEG_INF)[:, :a.shape[1]]


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Negative log p(labels | inputs) per sequence.

    log_probs: [B, T, C] log-softmax outputs (C includes the blank),
    labels: [B, L] int padded, input_lengths/label_lengths: [B].
    """
    lp = log_probs.float()
    T = lp.shape[1]
    ext = _extended_labels(labels.long(), blank)              # [B, S]
    S = ext.shape[1]
    # alpha[s] may also come from s-2 when ext[s] is a label differing
    # from ext[s-2] (the CTC skip rule)
    ext_m2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)               # [B, S]
    s_idx = torch.arange(S, device=lp.device)[None, :]
    alpha = torch.where(s_idx < 2, lp[:, 0].gather(1, ext), NEG_INF)
    for t in range(1, T):
        emit = lp[:, t].gather(1, ext)                         # [B, S]
        prev2 = torch.where(can_skip, _shift(alpha, 2), NEG_INF)
        new = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                              prev2) + emit
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    # total prob = alpha[2*label_len] (final blank) + alpha[2*label_len - 1]
    send = (2 * label_lengths).long()[:, None]                 # [B, 1]
    a_last = alpha.gather(1, send)[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(send - 1, 0))[:, 0]
    # an empty label sequence only has the final-blank path
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    return -torch.logaddexp(a_last, a_prev)


def ctc_greedy_decode(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      blank: int = 0):
    """Best-path decode: argmax per frame, collapse repeats, drop blanks.
    Returns (decoded [B, T] int32 padded with blank, lengths [B])."""
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)     # [B, T]
    B, T = ids.shape
    prev = torch.nn.functional.pad(ids, (1, 0), value=-1)[:, :T]
    frame_valid = (torch.arange(T, device=ids.device)[None, :]
                   < input_lengths[:, None])
    keep = (ids != blank) & (ids != prev) & frame_valid       # [B, T]
    # stable left-compaction of kept symbols; the rest land in column T
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    out = torch.full((B, T + 1), blank, dtype=torch.int32, device=ids.device)
    out.scatter_(1, pos.long(), ids)
    return out[:, :T], keep.sum(dim=1).to(torch.int32)
