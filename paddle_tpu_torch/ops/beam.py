"""Fixed-width batched beam search (counterpart of
``paddle_tpu/ops/beam.py``).

The beam is a static [batch, beam] lattice: every step scores all
beam x vocab continuations with one call of the step function, takes a
single top-k (ties to the lower flat index, as ``lax.top_k``), and
gathers the recurrent state by parent index. Finished beams are masked
(forced to extend with EOS at zero cost), so shapes stay static. The
loop's condition reads one flag from the device per step.
"""

from typing import Callable, Tuple

import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.ops.topk import top_k

NEG_INF = -1e30


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a nest of tuples, named tuples,
    lists and dicts (None and other leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _gather_beams(tree, parent: torch.Tensor):
    """Gather leaves [B, K, ...] along the beam axis by parent [B, K]."""
    def g(x):
        idx = parent.long().reshape(tuple(parent.shape)
                                    + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(tuple(parent.shape)
                                             + tuple(x.shape[2:])))
    return tree_map(g, tree)


def beam_search(step_fn: Callable, init_state, batch: int, beam_size: int,
                vocab: int, bos_id: int, eos_id: int, max_len: int,
                length_penalty: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run beam search.

    step_fn(tokens_last [B, K] int32, state) -> (logp [B, K, V],
    new_state); init_state's leaves are [B, K, ...] (the encoder context
    tiled over K). The search runs on the device of init_state's first
    tensor (the card if it has none). Returns (tokens
    [B, K, max_len], lengths [B, K], scores [B, K]) sorted best-first
    (a stable sort: equal scores keep their beam order), eos included in
    the length.
    """
    leaves = _leaves(init_state)
    device = place.resolve_device(leaves[0].device if leaves else None)
    K, V = beam_size, vocab
    tokens = torch.full((batch, K, max_len + 1), eos_id, dtype=torch.int32,
                        device=device)
    tokens[:, :, 0] = bos_id
    # only beam 0 live at t=0 so identical bos paths aren't duplicated
    scores = torch.where(torch.arange(K, device=device)[None, :] == 0, 0.0,
                         NEG_INF).expand(batch, K).float()
    finished = torch.zeros((batch, K), dtype=torch.bool, device=device)
    lengths = torch.zeros((batch, K), dtype=torch.int32, device=device)
    state = init_state
    eos_only = torch.full((V,), NEG_INF, device=device)
    eos_only[eos_id] = 0.0
    t = 0
    while t < max_len and not bool(finished.all()):
        logp, new_state = step_fn(tokens[:, :, t], state)
        # finished beams may only "extend" with eos at zero cost
        logp = torch.where(finished[:, :, None], eos_only[None, None, :],
                           logp.float())
        total = scores[:, :, None] + logp                     # [B, K, V]
        scores, top_idx = top_k(total.reshape(batch, K * V), K)
        parent = top_idx // V
        tok = (top_idx % V).to(torch.int32)
        tokens = _gather_beams(tokens, parent)
        tokens[:, :, t + 1] = tok
        was_finished = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent)
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | (tok == eos_id)
        state = _gather_beams(new_state, parent)
        t += 1

    final = scores
    if length_penalty > 0.0:
        final = final / (lengths.float() ** length_penalty)
    order = torch.argsort(-final, dim=1, stable=True)
    tokens = _gather_beams(tokens[:, :, 1:], order)
    return tokens, torch.gather(lengths, 1, order), \
        torch.gather(final, 1, order)


def cross_entropy_over_beam(step_scores: torch.Tensor, parents: torch.Tensor,
                            gold_scores: torch.Tensor, gold_slot: torch.Tensor,
                            valid_mask: torch.Tensor = None) -> torch.Tensor:
    """Globally-normalized beam-training loss, fixed-width: every path in
    the final beam scores the sum of its candidates' scores along its
    ancestry; a softmax over the paths (plus the gold path as one extra
    slot when it fell off the beam) gives -log p(gold).

    Args:
      step_scores: [B, S, K] score of the candidate in beam slot k at
        expansion step s (differentiated through).
      parents: [B, S, K] int — the slot at step s-1 each candidate
        extends (step 0 entries ignored).
      gold_scores: [B, S] per-step scores of the gold prefix.
      gold_slot: [B] int — the gold path's slot in the final beam, or -1.
      valid_mask: optional [B, K] bool — final slots holding real paths.
    Returns: [B] per-sequence loss.
    """
    B, S, K = step_scores.shape
    # step 0 folds in through a parent gather against a zero carry
    path = torch.zeros((B, K), dtype=torch.float32,
                       device=step_scores.device)
    for s in range(S):
        path = step_scores[:, s].float() + torch.gather(
            path, 1, parents[:, s].long())
    if valid_mask is not None:
        path = torch.where(valid_mask, path, NEG_INF)
    gold_total = gold_scores.float().sum(dim=1)              # [B]
    in_beam = gold_slot >= 0                                 # [B]
    extra = torch.where(in_beam, NEG_INF, gold_total)        # [B]
    logits = torch.cat([path, extra[:, None]], dim=1)        # [B, K+1]
    slot = torch.where(in_beam, torch.clamp_min(gold_slot, 0), K)
    target = torch.gather(logits, 1, slot.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=1) - target


def greedy_search(step_fn: Callable, init_state, batch: int, vocab: int,
                  bos_id: int, eos_id: int, max_len: int):
    """Greedy decode = beam_size 1."""
    tok, lens, sc = beam_search(step_fn, init_state, batch, 1, vocab,
                                bos_id, eos_id, max_len)
    return tok[:, 0], lens[:, 0], sc[:, 0]
