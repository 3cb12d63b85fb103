"""Linear-chain CRF: log-likelihood and Viterbi decoding (counterpart of
``paddle_tpu/ops/crf.py``).

Transitions are the (N+2)-row parameterization: row 0 start weights,
row 1 end weights, rows 2: the pairwise matrix (trans[i, j] = score of
moving from tag i to tag j). Emissions are padded batch-major [B, T, N]
with per-sequence lengths; the dynamic programs are Python loops over
time of dense [B, N, N] logsumexp / max steps, differentiated by
autograd.
"""

import torch


def _split_transitions(transitions: torch.Tensor):
    return transitions[0], transitions[1], transitions[2:]


def crf_log_norm(emissions: torch.Tensor, lengths: torch.Tensor,
                 transitions: torch.Tensor) -> torch.Tensor:
    """log Z per sequence. emissions [B, T, N] float, lengths [B]."""
    start, end, trans = _split_transitions(transitions)
    em = emissions.float()
    trans = trans.float()
    alpha = start[None, :].float() + em[:, 0]
    for t in range(1, em.shape[1]):
        # [B, prev, next]: alpha + trans, logsumexp over prev
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + em[:, t]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
    return torch.logsumexp(alpha + end[None, :].float(), dim=-1)


def crf_sequence_score(emissions: torch.Tensor, tags: torch.Tensor,
                       lengths: torch.Tensor, transitions: torch.Tensor
                       ) -> torch.Tensor:
    """Unnormalized score of the given tag paths. tags [B, T] int."""
    start, end, trans = _split_transitions(transitions)
    em = emissions.float()
    T = em.shape[1]
    tags = tags.long()
    step_idx = torch.arange(T, device=em.device)[None, :]
    valid = step_idx < lengths[:, None]                       # [B, T]
    emit = em.gather(-1, tags[..., None])[..., 0]
    score = torch.where(valid, emit, 0.0).sum(dim=1)
    score = score + start.float()[tags[:, 0]]
    pair = trans.float()[tags[:, :-1], tags[:, 1:]]           # [B, T-1]
    pair_valid = step_idx[:, 1:] < lengths[:, None]
    score = score + torch.where(pair_valid, pair, 0.0).sum(dim=1)
    last = tags.gather(1, (lengths.long() - 1)[:, None])[:, 0]
    return score + end.float()[last]


def crf_log_likelihood(emissions: torch.Tensor, tags: torch.Tensor,
                       lengths: torch.Tensor, transitions: torch.Tensor
                       ) -> torch.Tensor:
    """Per-sequence log p(tags | emissions). Negate for the cost."""
    return (crf_sequence_score(emissions, tags, lengths, transitions)
            - crf_log_norm(emissions, lengths, transitions))


def crf_decode(emissions: torch.Tensor, lengths: torch.Tensor,
               transitions: torch.Tensor):
    """Viterbi decode -> (best_tags [B, T] int32, best_score [B]). Ties
    go to the lower tag (``argmax``'s first maximum); padded steps
    repeat the final tag."""
    start, end, trans = _split_transitions(transitions)
    em = emissions.float()
    T = em.shape[1]
    trans_f = trans.float()
    delta = start[None, :].float() + em[:, 0]
    bps = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans_f[None]            # [B, prev, next]
        bps.append(scores.argmax(dim=1))
        delta = torch.where((t < lengths)[:, None],
                            scores.amax(dim=1) + em[:, t], delta)
    final = delta + end[None, :].float()
    best_score, tag = final.amax(dim=-1), final.argmax(dim=-1)
    tags = [tag]
    for t in range(T - 1, 0, -1):
        prev = bps[t - 1].gather(1, tag[:, None])[:, 0]
        # step t only happened for sequences with t < length
        tag = torch.where(t < lengths, prev, tag)
        tags.append(tag)
    return torch.stack(tags[::-1], dim=1).to(torch.int32), best_score
