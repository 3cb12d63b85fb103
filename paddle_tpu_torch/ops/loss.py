"""Loss / cost functions (counterpart of ``paddle_tpu/ops/loss.py``).

All return per-example losses [batch] in fp32; reduction is the
caller's choice.
"""

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Integer labels [...] against logits [..., classes] -> per-example
    loss [...] in fp32: log-softmax in fp32, minus the label's entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def soft_cross_entropy(logits: torch.Tensor, label_probs: torch.Tensor
                       ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(label_probs * logp).sum(dim=-1)


def cross_entropy_with_probs(probs: torch.Tensor, labels: torch.Tensor,
                             eps=1e-8) -> torch.Tensor:
    """CE against already-softmaxed probabilities."""
    p = probs.gather(-1, labels.long()[..., None])[..., 0]
    return -torch.log(p + eps)


def binary_cross_entropy(p: torch.Tensor, label: torch.Tensor, eps=1e-8
                         ) -> torch.Tensor:
    p = p.float()
    return -(label * torch.log(p + eps) + (1 - label) * torch.log(1 - p + eps))


def multi_binary_cross_entropy(p: torch.Tensor, labels: torch.Tensor,
                               eps=1e-8) -> torch.Tensor:
    """Sum of per-class BCE."""
    return binary_cross_entropy(p, labels, eps).sum(dim=-1)


def _sum_but_first(t):
    return t.sum(dim=tuple(range(1, t.dim()))) if t.dim() > 1 else t


def square_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5*||pred-t||^2."""
    d = (pred - target).float()
    return 0.5 * _sum_but_first(d * d)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, delta=1.0
              ) -> torch.Tensor:
    d = (pred - target).float().abs()
    per = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _sum_but_first(per)


def huber_classification(pred: torch.Tensor, label: torch.Tensor
                         ) -> torch.Tensor:
    """Two-class huber on {0,1} labels, mapped to {-1,1}."""
    y = 2.0 * label.float() - 1.0
    a = y * pred.float().squeeze(-1)
    return torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, (1.0 - a).square(), 0.0))


def hinge(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    y = 2.0 * label.float() - 1.0
    return torch.clamp_min(1.0 - y * pred.float().squeeze(-1), 0.0)


def rank_cost(left: torch.Tensor, right: torch.Tensor, label: torch.Tensor
              ) -> torch.Tensor:
    """Pairwise ranking (RankNet) cost: C = -o*label + log(1+exp(o)),
    o = left - right."""
    o = (left - right).float().squeeze(-1)
    return F.softplus(o) - o * label.float()


def huber_regression(pred: torch.Tensor, target: torch.Tensor,
                     delta: float = 1.0) -> torch.Tensor:
    """Huber regression loss summed over output dims."""
    a = (pred - target).float().abs()
    per_dim = torch.where(a <= delta, 0.5 * a.square(),
                          delta * (a - 0.5 * delta))
    return per_dim.sum(dim=-1)


def cross_entropy_with_selfnorm(logits: torch.Tensor, labels: torch.Tensor,
                                alpha: float = 0.1) -> torch.Tensor:
    """CE + alpha * log(Z)^2 self-normalisation penalty."""
    lf = logits.float()
    log_z = torch.logsumexp(lf, dim=-1)
    ce = log_z - lf.gather(-1, labels.long()[..., None])[..., 0]
    return ce + alpha * log_z.square()


def lambda_rank(scores: torch.Tensor, relevance: torch.Tensor,
                lengths: torch.Tensor, ndcg_num: int = 5) -> torch.Tensor:
    """LambdaRank NDCG cost per query: each mis-ordered pair's RankNet
    logistic loss weighted by the (no-gradient) |ΔNDCG| of swapping the
    pair at the current ranking, truncated at ``ndcg_num``.

    scores/relevance: [B, T] padded query lists; returns [B] costs.
    The rankings are stable sorts (``jnp.argsort`` is stable): ties rank
    the lower index first."""
    b, t = scores.shape
    dev = scores.device
    mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    s = torch.where(mask, scores.float(), float("-inf"))
    rel = torch.where(mask, relevance.float(), 0.0)
    order = torch.argsort(-s, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True).float()
    disc = torch.where(ranks < ndcg_num, 1.0 / torch.log2(ranks + 2.0), 0.0)
    gain = (torch.exp2(rel) - 1.0) * mask
    rel_best = torch.sort(rel, dim=1, descending=True).values
    pos = torch.arange(t, dtype=torch.float32, device=dev)[None, :]
    ideal_disc = torch.where((pos < ndcg_num) & (pos < lengths[:, None]),
                             1.0 / torch.log2(pos + 2.0), 0.0)
    idcg = torch.clamp_min(((torch.exp2(rel_best) - 1.0)
                            * ideal_disc).sum(dim=1), 1e-8)
    dgain = gain[:, :, None] - gain[:, None, :]
    ddisc = disc[:, :, None] - disc[:, None, :]
    delta = (dgain * ddisc).abs() / idcg[:, None, None]
    valid = mask[:, :, None] & mask[:, None, :]
    better = (rel[:, :, None] > rel[:, None, :]) & valid
    diff = torch.where(valid, s[:, :, None] - s[:, None, :], 0.0)
    w = torch.where(better, delta, 0.0).detach()
    return (w * F.softplus(-diff)).sum(dim=(1, 2))
