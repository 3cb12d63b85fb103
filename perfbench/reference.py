"""The plain reference: GPT-2 as the port's transformer computes it, in
float32 PyTorch, with no kernel, cache or batching of the program.

The architecture is GPT-2's (learned positions, pre-layer-norm blocks,
tanh GELU MLP, tied vocab head) as the port builds it, which has no
bias on the four projections (GPT-2 has them; the configuration files
list this under ``assumed``). It imports nothing of the port and takes
only what the benchmark made: weights from the seed, token ids, and the
tokens the program served, which it only judges.

``fp8=True`` is the control: the same forward with every tensor that
the configurations hold in bf16 (the matmul weights, the embedding's
and every layer's activations, the residual stream, q, k and v) held
in float8 e4m3 instead, one scale per tensor, as the program holds them
in bf16; in training the gradients flowing back through those tensors
are held in float8 e5m2. What the configurations hold in fp32 (the
norms' arithmetic, attention's softmax, the vocab head, the loss) stays
fp32.
"""

import math
from typing import Dict, List

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x, fmt):
    """``x`` rounded to the fp8 format ``fmt`` with one scale for the
    tensor (its largest magnitude maps to the format's largest), back in
    fp32."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX[fmt] / amax
    return (x * scale).to(fmt).float() / scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return _round(g, E5M2)


def _q(x, fp8: bool):
    return _Fp8.apply(x) if fp8 else x


def _ln(x, g, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def hidden(w: Dict, tokens, sz, fp8: bool = False):
    """tokens [B, T] (positions 0..T-1) -> final hidden state [B, T, D]
    after ``ln_f``, fp32. ``w`` is the flat leaf dict
    (``weights.flat``), every leaf fp32."""
    def q(x):
        return _q(x, fp8)

    B, T = tokens.shape
    H, Dh, D = sz.n_heads, sz.head_dim, sz.d_model
    x = q(q(w["embed"][tokens.long()]) + q(w["pos"][:T][None]))
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for li in range(sz.n_layers):
        h = q(_ln(x, w["ln1"][li], w["ln1_b"][li]))
        qkv = q(h @ q(w["qkv"][li]))
        qh, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2)
                    for t in qkv.split(D, dim=-1))
        s = (qh @ k.transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~causal, float("-inf"))
        a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
        x = q(x + q(q(a) @ q(w["attn_out"][li])))
        h2 = q(_ln(x, w["ln2"][li], w["ln2_b"][li]))
        ff = q(_gelu_tanh(q(h2 @ q(w["mlp_in"][li]))))
        x = q(x + q(ff @ q(w["mlp_out"][li])))
    return q(_ln(x, w["ln_f"], w["ln_f_b"]))


def logits(w: Dict, tokens, sz, fp8: bool = False):
    """tokens [B, T] -> logits [B, T, V], fp32 (the vocab head is fp32
    in the configurations, so in the control too)."""
    return hidden(w, tokens, sz, fp8) @ w["embed"].T


# ---------------------------------------------------------------------------
# serving: the gap of each served token below the reference's best
# ---------------------------------------------------------------------------

def served_gaps(w: Dict, sz, prompt: List[int], served: List[int],
                device, fp8_control: bool = False) -> Dict[str, float]:
    """Teacher-forced over prompt + served tokens: at the position that
    produced each served token, how far the reference's logit of that
    token lies below the reference's largest (``gap``); with
    ``fp8_control``, also the gap of the token the fp8 control puts first
    at each of those positions (``control_gap``). Widest over the
    request's served tokens."""
    ids = list(prompt) + list(served[:-1])
    tok = torch.tensor([ids], dtype=torch.int64, device=device)
    first = len(prompt) - 1
    with torch.no_grad():
        ref = logits(w, tok, sz)[0, first:]
        want = torch.tensor(served, dtype=torch.int64, device=device)
        best = ref.max(dim=-1).values
        got = ref.gather(1, want[:, None])[:, 0]
        out = {"gap": float((best - got).max())}
        if fp8_control:
            ctl = logits(w, tok, sz, fp8=True)[0, first:]
            pick = ctl.argmax(dim=-1)
            cg = best - ref.gather(1, pick[:, None])[:, 0]
            out["control_gap"] = float(cg.max())
    return out


# ---------------------------------------------------------------------------
# training: the loss, the gradients and Adam's update
# ---------------------------------------------------------------------------

def adam_step(params: Dict, grads: Dict, state: Dict, step: int,
              lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with bias correction, in place on fp32 leaves; ``step`` counts
    from 0."""
    t = step + 1
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))


def train_steps(w: Dict, batches, sz, lr: float, rows: int = 2,
                fp8: bool = False, half_batch: bool = False) -> dict:
    """Three (or ``len(batches)``) Adam steps from the fp32 leaves ``w``
    (updated in place) on ``batches`` ([B, T + 1] ids each; inputs are
    the first T, targets the last T): each step's mean next-token loss,
    the first step's gradient norm per leaf, and the norm per leaf of
    the change after the last step. The batch runs ``rows`` sequences at
    a time, the gradients summed over the blocks. ``half_batch`` is a
    fault: each step's loss and gradient over the first half of the
    rows alone."""
    before = {k: v.detach().clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(True)
    state, losses, grad_norms = {}, [], None
    for i, batch in enumerate(batches):
        if half_batch:
            batch = batch[:batch.shape[0] // 2]
        B, T = batch.shape[0], batch.shape[1] - 1
        total = torch.zeros((), dtype=torch.float64, device=batch.device)
        for r in range(0, B, rows):
            part = batch[r:r + rows]
            lg = logits(w, part[:, :T], sz, fp8)
            ce = torch.nn.functional.cross_entropy(
                lg.reshape(-1, sz.vocab), part[:, 1:].reshape(-1).long(),
                reduction="sum") / (B * T)
            ce.backward()
            total += ce.detach().double()
            del lg, ce
        losses.append(float(total))
        grads = {k: v.grad for k, v in w.items()}
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        adam_step(w, grads, state, i, lr)
        for v in w.values():
            v.grad = None
    change = {k: float((w[k].detach() - before[k]).norm()) for k in w}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
