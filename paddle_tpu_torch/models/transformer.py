"""Decoder-only transformer LM, serving and training paths (counterpart
of ``paddle_tpu/models/transformer.py``).

Parameters are a dict of tensors with the blocks stacked on a leading
layer axis, as in the JAX package, and every weight keeps the JAX
orientation (``qkv`` is [L, D, D + 2*kvd], so ``h @ w`` reads the
same). ``paddle_tpu`` keeps fp32 parameters and casts the matmul weights
to ``cfg.dtype`` at every use (``w["qkv"].astype(h.dtype)``); the port
casts them once, when they are made or loaded — the values are the same.
The embedding stays fp32 because the vocab head computes its logits in
fp32, and the norms' scales stay fp32 because layer norm computes in
fp32.

The paged pool is head-major, ``[L, Hkv, M, Dh]`` per k/v with
``M = num_blocks * block_size``, and the step functions update it IN
PLACE (the JAX functions return a new pool; these return the one they
were given). Attention and the pool's span writes go through the kernel
wrappers of ``ops/kernels``; the dense projections stay ``torch.matmul``
as they stayed XLA matmuls in the JAX package.

Training keeps the JAX package's layout instead: an fp32 tree whose
leaves require grad (:func:`init_train_params`,
:func:`train_params_from_numpy`), and :func:`forward` / :func:`lm_loss`
cast each matmul weight to ``cfg.dtype`` at use, as the JAX forward
does (a no-op on the serving dict, whose weights are already in
``cfg.dtype``). Without ``lengths``, attention runs
:func:`ops.kernels.attention.flash_attention`, whose forward and
backward are the flash kernels; with ``lengths`` (which the flash
kernels do not take, in the JAX package either) the plain
:func:`parallel.ring.full_attention`.
"""

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import dtypes, place
from paddle_tpu_torch.ops import loss as ops_loss
from paddle_tpu_torch.ops import norm
from paddle_tpu_torch.ops.kernels import attention as kattention
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.ops.kernels import prefill as kprefill
from paddle_tpu_torch.parallel import ring

MATMUL_WEIGHTS = ("qkv", "attn_out", "mlp_in", "mlp_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of ``paddle_tpu``'s config that the serving and
    training slices read. Experts, ring attention and remat are not
    ported: setting them raises ``NotImplementedError``."""
    vocab: int
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 0                # 0 = MHA; fewer = grouped-query
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 2048
    dtype: object = torch.bfloat16
    dropout: float = 0.0               # residual/embedding dropout rate
    use_rope: bool = False             # rotary q/k instead of learned
    rope_theta: float = 10000.0        # absolute positions
    use_ring_attention: bool = False
    remat: str = "none"
    moe_experts: int = 0

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtypes.resolve(self.dtype))
        if self.moe_experts:
            raise NotImplementedError("moe_experts: not ported")
        if self.use_ring_attention:
            raise NotImplementedError("use_ring_attention: not ported")
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r}: not ported")
        _ = self.kv_heads                   # validates the head split

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        h = self.n_kv_heads or self.n_heads
        if h <= 0 or self.n_heads % h:
            raise ValueError(f"n_heads={self.n_heads} must be a multiple "
                             f"of n_kv_heads={h}")
        return h


def _place(tree: Dict, cfg: TransformerConfig, device) -> Dict:
    """Move a parameter dict to ``device``: matmul weights in
    ``cfg.dtype``, everything else fp32."""
    def leaf(name, t):
        dt = cfg.dtype if name in MATMUL_WEIGHTS else torch.float32
        return t.to(device=device, dtype=dt).contiguous()

    out = {k: leaf(k, v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: leaf(k, v) for k, v in tree["blocks"].items()}
    return out


def _trainable(tree: Dict, device) -> Dict:
    """An fp32 copy of a parameter dict on ``device``, every leaf a
    leaf tensor that requires grad."""
    def leaf(t):
        return t.to(device=device, dtype=torch.float32).contiguous() \
            .requires_grad_(True)

    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: leaf(v) for k, v in tree["blocks"].items()}
    return out


def _draw(cfg: TransformerConfig, generator) -> Dict:
    """fp32 CPU parameters with ``paddle_tpu``'s shapes and scales."""
    D, F_, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    kvd = cfg.kv_heads * cfg.head_dim
    s = 1.0 / math.sqrt(D)

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator) * scale

    tree = {
        "embed": nrm((V, D), 1.0 / math.sqrt(D)),
        # rope computes positions analytically: a 1-row stub keeps the
        # tree the same shape for either config, as in the JAX package
        "pos": (nrm((cfg.max_len, D), 0.02) if not cfg.use_rope
                else torch.zeros((1, D))),
        "blocks": {
            "ln1": torch.ones((L, D)),
            "ln1_b": torch.zeros((L, D)),
            "qkv": nrm((L, D, D + 2 * kvd), s),
            "attn_out": nrm((L, D, D), s / math.sqrt(2 * L)),
            "ln2": torch.ones((L, D)),
            "ln2_b": torch.zeros((L, D)),
            "mlp_in": nrm((L, D, F_), s),
            "mlp_out": nrm((L, F_, D), 1.0 / math.sqrt(F_) / math.sqrt(2 * L)),
        },
        "ln_f": torch.ones((D,)),
        "ln_f_b": torch.zeros((D,)),
    }
    return tree


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random serving parameters with ``paddle_tpu``'s shapes and scales
    (normal draws from ``generator``, made on the CPU so a seed gives the
    same values on any device), matmul weights in ``cfg.dtype``. Runs on
    the card unless ``device`` says otherwise."""
    return _place(_draw(cfg, generator), cfg, place.resolve_device(device))


def init_train_params(cfg: TransformerConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Dict:
    """The same draws as :func:`init_params` as a training tree: every
    leaf fp32 and requiring grad (the optimizer's master weights)."""
    return _trainable(_draw(cfg, generator), place.resolve_device(device))


def _from_numpy(tree: Dict) -> Dict:
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    flat = {k: t(v) for k, v in tree.items() if k != "blocks"}
    flat["blocks"] = {k: t(v) for k, v in tree["blocks"].items()}
    return flat


def params_from_numpy(tree: Dict, cfg: TransformerConfig,
                      device=None) -> Dict:
    """``paddle_tpu``'s parameter tree, already converted to numpy
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's
    serving tensors — same names, shapes and orientation. Runs on the
    card unless ``device`` says otherwise."""
    return _place(_from_numpy(tree), cfg, place.resolve_device(device))


def train_params_from_numpy(tree: Dict, device=None) -> Dict:
    """``paddle_tpu``'s parameter tree as numpy, as a training tree
    (fp32 leaves requiring grad). Runs on the card unless ``device``
    says otherwise."""
    return _trainable(_from_numpy(tree), place.resolve_device(device))


def params_to_numpy(tree: Dict) -> Dict:
    """A parameter tree (either kind) as fp32 numpy arrays, the layout
    ``paddle_tpu`` loads."""
    def a(t):
        return t.detach().to("cpu", torch.float32).numpy()

    out = {k: a(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: a(v) for k, v in tree["blocks"].items()}
    return out


def init_block_pool(cfg: TransformerConfig, num_blocks: int,
                    block_size: int, kv_dtype: Optional[str] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """Paged KV pool, head-major: {"k", "v"} each
    [L, kv_heads, num_blocks * block_size, Dh] in the model dtype, zeroed.
    Block ``i`` owns positions ``[i*block_size, (i+1)*block_size)`` of
    the flat position axis. Quantized pools are the next slice."""
    kdecode._no_quant(kv_dtype)
    device = place.resolve_device(device)
    shape = (cfg.n_layers, cfg.kv_heads, int(num_blocks) * int(block_size),
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def pool_from_numpy(pool: Dict, cfg: TransformerConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` pool ({"k", "v"} as numpy) as the port's pool."""
    if set(pool) != {"k", "v"}:
        raise NotImplementedError("quantized KV pools are not ported yet")
    device = place.resolve_device(device)
    return {n: torch.from_numpy(np.asarray(pool[n], np.float32).copy())
            .to(device=device, dtype=cfg.dtype).contiguous()
            for n in ("k", "v")}


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [T, Dh/2] for the given global positions."""
    if head_dim % 2:
        raise ValueError(f"RoPE requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32) / half)
    ang = positions.float()[:, None] * freqs.to(positions.device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Pairing-halves rotation of x's last axis in fp32, cast back:
    (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding over the head dim of x [B, T, H, Dh] with tables
    [T, Dh/2]."""
    cos, sin = tables
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _rope_rows(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding, one token per row: x [B, H, Dh] with per-row
    tables [B, Dh/2]."""
    cos, sin = tables
    return _rotate(x, cos[:, None, :], sin[:, None, :])


def _embed_rows(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token-embedding gather, cast to the model dtype."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def _vocab_logits(x: torch.Tensor, params) -> torch.Tensor:
    """Tied vocab head in fp32: [N, D] -> [N, V]."""
    return x.float() @ params["embed"].float().T


def _mlp(h2, w, li):
    """The dense FFN of layer ``li``, weights cast to the activations'
    dtype at use (a no-op on the serving dict)."""
    ff = F.gelu(h2 @ w["mlp_in"][li].to(h2.dtype), approximate="tanh")
    return ff @ w["mlp_out"][li].to(ff.dtype)


def _dropout(h: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate
    (uniform draws from ``generator``, which must live on ``h``'s
    device) and scale the kept ones by 1 / (1 - rate)."""
    if rate <= 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) \
        < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), 0.0).to(h.dtype)


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            lengths: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] fp32: the JAX forward
    with ``head="all"``. ``lengths`` [B] masks keys at or past each
    row's length (plain attention then, as in the JAX package);
    ``generator`` enables inverted dropout at ``cfg.dropout`` on the
    embedding and both residual branches of every block, drawn on the
    tokens' device — omit it for a deterministic forward. The
    prefill/decode heads (``head="last"``/``"gather"``) and
    ``return_kv`` are not ported."""
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"cfg.dropout must be in [0, 1), got {cfg.dropout}")
    rate = cfg.dropout if generator is not None else 0.0
    B, T = tokens.shape
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    kvd = Hkv * Dh
    dt = cfg.dtype
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    if not cfg.use_rope:
        x = x + params["pos"][:T].to(dt)[None]
    x = _dropout(x, rate, generator)
    rope_tabs = (_rope_tables(torch.arange(T, device=tokens.device), Dh,
                              cfg.rope_theta) if cfg.use_rope else None)
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once instead of adding L full-size zero tensors
    w = {k: t.unbind(0) for k, t in params["blocks"].items()}
    for li in range(cfg.n_layers):
        h = norm.layer_norm(x, w["ln1"][li], w["ln1_b"][li])
        qkv = h @ w["qkv"][li].to(h.dtype)
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        q = q.reshape(B, T, H, Dh)
        k = k.reshape(B, T, Hkv, Dh)
        v = v.reshape(B, T, Hkv, Dh)
        if cfg.use_rope:
            q, k = _rope(q, rope_tabs), _rope(k, rope_tabs)
        if lengths is None:
            attn = kattention.flash_attention(q, k, v, causal=True)
        else:
            attn = ring.full_attention(q, k, v, causal=True, lengths=lengths)
        attn = attn.reshape(B, T, cfg.d_model)
        x = x + _dropout(attn @ w["attn_out"][li].to(attn.dtype), rate,
                         generator)
        h2 = norm.layer_norm(x, w["ln2"][li], w["ln2_b"][li])
        x = x + _dropout(_mlp(h2, w, li), rate, generator)
    x = norm.layer_norm(x, params["ln_f"], params["ln_f_b"])
    return _vocab_logits(x, params)


def lm_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, *,
            lengths: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the valid positions (all of
    them, or those before each row's ``lengths``): a 0-d fp32 tensor.
    The JAX loss adds the MoE load-balance term, which is 0 for the
    dense configs the port runs."""
    logits = forward(params, tokens, cfg, lengths=lengths,
                     generator=generator)
    tok_ce = ops_loss.softmax_cross_entropy(logits, targets)
    if lengths is not None:
        T = tokens.shape[1]
        mask = (torch.arange(T, device=tok_ce.device)[None, :]
                < lengths.to(tok_ce.device)[:, None]).float()
    else:
        mask = torch.ones_like(tok_ce)
    return (tok_ce * mask).sum() / mask.sum().clamp_min(1.0)


def decode_step_paged(params, pool, tokens: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      pages: torch.Tensor, cfg: TransformerConfig, *,
                      block_size: int):
    """One decode step over the paged pool: tokens [B] int32, pos [B]
    int32, active [B] bool, pages [B, P] int32 -> (logits [B, vocab]
    fp32, pool). Active row b writes its new k/v at pool position
    ``pages[b, pos[b] // bs] * bs + pos[b] % bs`` (in place), then every
    row attends through ``flash_decode_attention``. Inactive rows write
    nothing — the JAX scatter drops them with ``mode="drop"``; here only
    the active rows are indexed at all."""
    B = tokens.shape[0]
    P = pages.shape[1]
    bs = int(block_size)
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    kvd, G = Hkv * Dh, H // Hkv
    w = params["blocks"]
    x = _embed_rows(params, tokens, cfg)
    if not cfg.use_rope:
        x = x + params["pos"][pos.long()].to(cfg.dtype)
    rope_tabs = (_rope_tables(pos, Dh, cfg.rope_theta) if cfg.use_rope
                 else None)
    # physical write row of each ACTIVE slot (inactive rows may sit past
    # their page vector: clamp before the gather, they never write)
    pg = (pos.long() // bs).clamp(max=P - 1)
    wrow = pages.long().gather(1, pg[:, None])[:, 0] * bs + pos.long() % bs
    act = active.nonzero()[:, 0]
    widx = wrow[act]
    for li in range(cfg.n_layers):
        kc, vc = pool["k"][li], pool["v"][li]        # [Hkv, M, Dh] views
        h = norm.layer_norm(x, w["ln1"][li], w["ln1_b"][li])
        qkv = h @ w["qkv"][li]
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        if cfg.use_rope:
            q = _rope_rows(q.reshape(B, H, Dh), rope_tabs).reshape(B, H * Dh)
            k = _rope_rows(k.reshape(B, Hkv, Dh), rope_tabs).reshape(B, kvd)
        kc[:, widx] = k.reshape(B, Hkv, Dh)[act].transpose(0, 1).to(kc.dtype)
        vc[:, widx] = v.reshape(B, Hkv, Dh)[act].transpose(0, 1).to(vc.dtype)
        attn = kdecode.flash_decode_attention(
            q.reshape(B, Hkv, G, Dh).contiguous(), kc, vc, pages, pos,
            block_size=bs)
        x = x + attn.reshape(B, cfg.d_model).to(cfg.dtype) @ w["attn_out"][li]
        h2 = norm.layer_norm(x, w["ln2"][li], w["ln2_b"][li])
        x = x + _mlp(h2, w, li)
    x = norm.layer_norm(x, params["ln_f"], params["ln_f_b"])
    return _vocab_logits(x, params), pool


def prefill_into_blocks(params, pool, tokens: torch.Tensor, length: int,
                        pages: torch.Tensor, cfg: TransformerConfig, *,
                        block_size: int):
    """Prefill ONE chunk of one prompt into its pool pages.

    tokens [1, C] is the chunk right-padded to its bucket; ``length``
    counts its valid tokens; pages [P] int32 covers context + chunk, the
    chunk on the last ``ceil(C / bs)`` pages, so the context already in
    the pool is ``S = (P - ceil(C / bs)) * bs`` tokens. Each layer's
    attention runs ``flash_chunk_prefill`` (context fully visible, chunk
    causal); after the layers, ``paged_span_write`` lands the chunk's
    K/V in its pages in place, valid rows only — padded rows map to
    unallocated page-table entries (0) and must never be written.
    Returns (logits at the last valid position [1, vocab] fp32, pool)."""
    if tokens.shape[0] != 1:
        raise ValueError(f"prefill_into_blocks takes one request "
                         f"([1, C] tokens), got {tuple(tokens.shape)}")
    C = tokens.shape[1]
    bs = int(block_size)
    P = pages.shape[0]
    pc = -(-C // bs)                    # pages the chunk itself spans
    S = (P - pc) * bs                   # context length
    if S < 0:
        raise ValueError(f"pages vector ({P}) shorter than the chunk's "
                         f"own span ({pc} pages for C={C})")
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    kvd, G = Hkv * Dh, H // Hkv
    dev = tokens.device
    w = params["blocks"]
    length = int(length)
    gpos = S + torch.arange(C, device=dev)
    x = _embed_rows(params, tokens[0], cfg)
    if not cfg.use_rope:
        # clip keeps padded rows (which never write) in range
        x = x + params["pos"][gpos.clamp(max=params["pos"].shape[0] - 1)
                              ].to(cfg.dtype)
    rope_tabs = (_rope_tables(gpos, Dh, cfg.rope_theta) if cfg.use_rope
                 else None)
    ctx_pages = pages[:P - pc]
    span_shape = (cfg.n_layers, Hkv, pc * bs, Dh)
    spans = {n: torch.zeros(span_shape, dtype=pool[n].dtype, device=dev)
             for n in ("k", "v")}
    for li in range(cfg.n_layers):
        h = norm.layer_norm(x, w["ln1"][li], w["ln1_b"][li])
        qkv = h @ w["qkv"][li]
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        if cfg.use_rope:
            q = _rope_rows(q.reshape(C, H, Dh), rope_tabs).reshape(C, H * Dh)
            k = _rope_rows(k.reshape(C, Hkv, Dh), rope_tabs).reshape(C, kvd)
        kck = k.reshape(C, Hkv, Dh).contiguous()
        vck = v.reshape(C, Hkv, Dh).contiguous()
        attn = kprefill.flash_chunk_prefill(
            q.reshape(C, Hkv, G, Dh).contiguous(), kck, vck,
            pool["k"][li], pool["v"][li], ctx_pages, block_size=bs)
        spans["k"][li, :, :C] = kck.transpose(0, 1)
        spans["v"][li, :, :C] = vck.transpose(0, 1)
        x = x + attn.reshape(C, cfg.d_model).to(cfg.dtype) @ w["attn_out"][li]
        h2 = norm.layer_norm(x, w["ln2"][li], w["ln2_b"][li])
        x = x + _mlp(h2, w, li)
    valid = torch.arange(pc * bs, device=dev) < length
    kprefill.paged_span_write(pool, spans, pages[P - pc:].contiguous(),
                              valid, block_size=bs)
    # only the last valid position feeds the vocab head
    last = max(length - 1, 0)
    x = norm.layer_norm(x[last:last + 1], params["ln_f"], params["ln_f_b"])
    return _vocab_logits(x, params), pool
