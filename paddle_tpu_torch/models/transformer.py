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
were given). A quantized pool (``kv_dtype`` "int8"/"int4") stores int8
codes (int4: two per byte) with one fp32 scale per (layer, head,
position) beside them.

The serving steps also take the int8-weight tree of
``io/lm_serving.quantize_lm_params``: each matmul weight is a
{"q8", "scale"} node, dequantized one layer at a time where it is used,
``(q8.float() * scale)`` in fp32, then cast to ``cfg.dtype`` for the
matmul, as ``paddle_tpu``'s decode step does inside its layer scan.
``paddle_tpu``'s prefill dequantizes the whole tree to fp32 first; the
dequant is elementwise and rounds once, so either order gives the same
bf16 operands bit for bit, and the port dequantizes per layer in both
steps. Attention and the pool's span writes go through the kernel
wrappers of ``ops/kernels``; the dense projections stay ``torch.matmul``
as they stayed XLA matmuls in the JAX package.

The row arena of the lockstep and slot paths is token-major,
``[L, B, max_len, Hkv, Dh]`` per k/v (:func:`init_cache`, the v3
artifact's layout), also updated in place: :func:`prefill` and
:func:`prefill_into_slot` run the training forward's block (kernel 5)
with the ``"last"`` / ``"gather"`` head and the stacked k/v
(:func:`_forward_impl`); :func:`decode_step` and
:func:`decode_step_slots` are one function over per-row positions whose
attention is ``paddle_tpu``'s XLA arena attention, in plain torch
(:func:`arena_attention`); :func:`generate` and :func:`beam_search`
drive them.

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

With a ``mesh`` (:func:`forward` / :func:`lm_loss`), every rank runs its
block of one SPMD step over the :func:`param_shardings` layout: tokens
split over the batch axes and ``seq`` (ring or all-to-all attention
under ``use_ring_attention``, the gathered global sequence without it),
heads, FFN and vocab over ``model``, experts over ``expert``;
:func:`sync_grads` sums the gradients over the token axes. Dropout
draws each global mask on every rank and keeps the rank's block.
:func:`prefill` and :func:`prefill_into_slot` take the mesh too and
return the global logits and arena on every rank; :func:`generate` and
:func:`beam_search` pass it to the prefill and decode on the whole tree.
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
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.ops import q8
from paddle_tpu_torch.ops.topk import top_k as _top_k
from paddle_tpu_torch.ops.kernels import attention as kattention
from paddle_tpu_torch.ops.kernels import decode as kdecode
from paddle_tpu_torch.ops.kernels import prefill as kprefill
from paddle_tpu_torch.parallel import compat, moe, ring, spmd

MATMUL_WEIGHTS = ("qkv", "attn_out", "mlp_in", "mlp_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """``paddle_tpu``'s config. ``use_ring_attention`` runs attention as
    context parallelism over a mesh's ``seq`` axis (``forward(mesh=)``):
    ``cp_mode`` "ring" rotates K/V around the ring (kernels 5/6 per
    step for packed batches), "alltoall" reshuffles sequence and heads
    (the seq axis must divide the head counts)."""
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
    cp_mode: str = "ring"              # "ring" | "alltoall"
    remat: str = "none"                # "none" | "bf16" | "q8": layer-
                                       # granular recompute; autograd
                                       # saves one (quantized) copy of
                                       # each block's input instead of
                                       # its intermediates
                                       # (ops/q8.q8_remat)
    moe_experts: int = 0               # >0: every FFN is a top-k MoE
                                       # over this many experts
                                       # (parallel/moe); 0 = dense mlp
    moe_top_k: int = 1                 # 1 = Switch; 2 = GShard top-2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01       # load-balance loss weight (added
                                       # to lm_loss per layer)

    def __post_init__(self):
        object.__setattr__(self, "dtype", dtypes.resolve(self.dtype))
        if self.cp_mode not in ("ring", "alltoall"):
            raise ValueError(
                f"cp_mode must be 'ring' or 'alltoall', got "
                f"{self.cp_mode!r}")
        if self.remat not in ("none", "bf16", "q8"):
            raise ValueError(f"remat must be 'none', 'bf16' or 'q8', got "
                             f"{self.remat!r}")
        _ = self.kv_heads                   # validates the head split

    def moe_cfg(self):
        """The ``parallel/moe.MoEConfig`` this FFN runs under."""
        return moe.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            num_experts=self.moe_experts,
            capacity_factor=self.moe_capacity_factor,
            aux_loss_weight=self.moe_aux_weight, top_k=self.moe_top_k)

    def serving_moe_cfg(self):
        """The MoE config of the serving steps: capacity factor E / k,
        so no token drops (every expert has room for every row)."""
        return dataclasses.replace(
            self.moe_cfg(),
            capacity_factor=float(self.moe_experts) / self.moe_top_k)

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
    ``cfg.dtype``, everything else fp32; an int8 {"q8", "scale"} node
    moves as it is."""
    def leaf(name, t):
        if q8.is_quantized_weight(t):
            return {k: v.to(device).contiguous() for k, v in t.items()}
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
    """fp32 CPU parameters with ``paddle_tpu``'s shapes and scales: an
    MoE config draws ``gate`` [L, D, E], ``moe_w_in`` [L, E, D, F] and
    ``moe_w_out`` [L, E, F, D] in place of ``mlp_in`` / ``mlp_out`` (the
    three stay fp32 in the serving dict too: the JAX package's MoE
    products are fp32)."""
    D, F_, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    kvd = cfg.kv_heads * cfg.head_dim
    s = 1.0 / math.sqrt(D)

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator) * scale

    if cfg.moe_experts:
        E = cfg.moe_experts
        ffn = {"gate": nrm((L, D, E), s),
               "moe_w_in": nrm((L, E, D, F_), s),
               "moe_w_out": nrm((L, E, F_, D),
                                1.0 / math.sqrt(F_) / math.sqrt(2 * L))}
    else:
        ffn = {"mlp_in": nrm((L, D, F_), s),
               "mlp_out": nrm((L, F_, D),
                              1.0 / math.sqrt(F_) / math.sqrt(2 * L))}
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
            **ffn,
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
        if isinstance(a, torch.Tensor):    # e.g. a bf16 leaf of an artifact
            return a.detach().float()
        if q8.is_quantized_weight(a):      # int8 codes, fp32 scales
            return {"q8": torch.from_numpy(np.asarray(a["q8"], np.int8)
                                           .copy()),
                    "scale": torch.from_numpy(np.asarray(a["scale"],
                                                         np.float32).copy())}
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    flat = {k: t(v) for k, v in tree.items() if k != "blocks"}
    flat["blocks"] = {k: t(v) for k, v in tree["blocks"].items()}
    return flat


def params_from_numpy(tree: Dict, cfg: TransformerConfig,
                      device=None) -> Dict:
    """``paddle_tpu``'s parameter tree, already converted to numpy
    (``jax.tree_util.tree_map(np.asarray, params)``), as the port's
    serving tensors — same names, shapes and orientation. A leaf may also
    be a tensor (an artifact's bf16 leaf), taken at its value. A tree from
    ``paddle_tpu``'s ``quantize_lm_params`` keeps its {"q8", "scale"}
    nodes, bytes and scales exactly. Runs on the card unless ``device``
    says otherwise."""
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
    """Paged KV pool, head-major, zeroed: {"k", "v"} each
    [L, kv_heads, num_blocks * block_size, Dh] in the model dtype.
    Block ``i`` owns positions ``[i*block_size, (i+1)*block_size)`` of
    the flat position axis.

    ``kv_dtype`` "int8" stores k/v as int8 codes with fp32 scale tables
    ``k_scale``/``v_scale`` [L, kv_heads, M], one per (layer, head,
    position); "int4" packs two codes per byte ([..., Dh // 2], the same
    scale tables). The page table indexes values and scales alike."""
    device = place.resolve_device(device)
    M = int(num_blocks) * int(block_size)
    if kv_dtype in (None, "none"):
        shape = (cfg.n_layers, cfg.kv_heads, M, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if kv_dtype not in q8.KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: one of "
                         f"{(None,) + q8.KV_DTYPES}")
    Dh = cfg.head_dim
    if kv_dtype == "int4":
        if Dh % 2:
            raise ValueError(f"int4 KV packs nibble pairs: head_dim {Dh} "
                             f"must be even")
        Dh //= 2
    shape = (cfg.n_layers, cfg.kv_heads, M, Dh)
    sshape = (cfg.n_layers, cfg.kv_heads, M)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def pool_kv_dtype(pool, cfg: TransformerConfig) -> str:
    """The storage a pool carries: ``"none"`` (model dtype), ``"int8"``
    or ``"int4"``, read from its arrays."""
    if "k_scale" not in pool:
        return "none"
    return ("int4" if pool["k"].shape[-1] == cfg.head_dim // 2
            and cfg.head_dim > 1 else "int8")


def kv_pool_bytes_per_token(cfg: TransformerConfig,
                            kv_dtype: Optional[str] = None) -> int:
    """Pool bytes one resident token costs across all layers: k and v
    rows plus, for a quantized pool, their two fp32 scales per head."""
    Hkv, Dh = cfg.kv_heads, cfg.head_dim
    if kv_dtype in (None, "none"):
        per = 2 * Hkv * Dh * torch.empty((), dtype=cfg.dtype).element_size()
    elif kv_dtype == "int8":
        per = 2 * Hkv * Dh + 2 * Hkv * 4
    elif kv_dtype == "int4":
        per = 2 * Hkv * (Dh // 2) + 2 * Hkv * 4
    else:
        raise ValueError(f"kv_dtype {kv_dtype!r}")
    return cfg.n_layers * per


def kv_rel_l2_budget(cfg: TransformerConfig, kv_dtype: str) -> float:
    """Global relative L2 budget of decode logits off a quantized pool
    against the unquantized pool, ``paddle_tpu``'s: symmetric rounding
    adds at most ``0.5 / qmax`` relative noise per element, each layer
    reads quantized K and V (2L injections that add in quadrature), so
    the logits see about ``sqrt(2L) * 0.5 / qmax``; the budget is twice
    that, capped at 0.5 — a wrong scale lands at O(1)."""
    half_step = 0.5 / q8.KV_QMAX[kv_dtype]
    return min(0.5, 2.0 * math.sqrt(2 * cfg.n_layers) * half_step)


def pool_from_numpy(pool: Dict, cfg: TransformerConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` pool as numpy ({"k", "v"}, plus the scale tables
    of a quantized pool) as the port's pool: model-dtype values cast to
    ``cfg.dtype``, int8 codes and fp32 scales carried across exactly."""
    device = place.resolve_device(device)
    if set(pool) == {"k", "v"}:
        return {n: torch.from_numpy(np.asarray(pool[n], np.float32).copy())
                .to(device=device, dtype=cfg.dtype).contiguous()
                for n in ("k", "v")}
    if set(pool) != {"k", "v", "k_scale", "v_scale"}:
        raise ValueError(f"pool arrays {sorted(pool)}: expected k, v and, "
                         f"for a quantized pool, k_scale and v_scale")
    want = {"k": np.int8, "v": np.int8, "k_scale": np.float32,
            "v_scale": np.float32}
    out = {}
    for n, dt in want.items():
        a = np.asarray(pool[n])
        if a.dtype != dt:
            raise ValueError(f"pool[{n!r}] is {a.dtype}, expected "
                             f"{np.dtype(dt)}")
        out[n] = torch.from_numpy(a.copy()).to(device).contiguous()
    return out


# (half, theta, device) -> the inverse frequencies, computed on the CPU
# once and kept on the device: a step captured into a CUDA graph may not
# copy from host memory
_ROPE_FREQS: Dict = {}


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    key = (half, float(theta), device)
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                          -torch.arange(half, dtype=torch.float32) / half)
        freqs = _ROPE_FREQS[key] = freqs.to(device)
    return freqs


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [T, Dh/2] for the given global positions."""
    if head_dim % 2:
        raise ValueError(f"RoPE requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    freqs = _rope_freqs(half, theta, positions.device)
    ang = positions.float()[:, None] * freqs[None, :]
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


def _blocks_quantized(params) -> bool:
    """True for the int8-weight tree of ``quantize_lm_params``: the
    block matmul weights ride as {"q8", "scale"} nodes."""
    return any(q8.is_quantized_weight(n) for n in params["blocks"].values())


def _tree_quantized(params) -> bool:
    """True for any int8-weight tree (embedding or blocks)."""
    return q8.is_quantized_weight(params["embed"]) or _blocks_quantized(params)


def _layer_weights(w: Dict, li: int, dtype) -> Dict[str, torch.Tensor]:
    """Layer ``li`` of the stacked block weights. A {"q8", "scale"}
    node dequantizes here, for this layer alone: ``q8 * scale`` in fp32,
    then cast to ``dtype`` for the matmul (a weight already in ``dtype``
    is taken as it is)."""
    out = {}
    for name, n in w.items():
        if q8.is_quantized_weight(n):
            out[name] = q8.dequantize_weight(
                {"q8": n["q8"][li], "scale": n["scale"][li]}).to(dtype)
        else:
            out[name] = n[li]
    return out


def _embed_rows(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token-embedding gather, cast to the model dtype (``F.embedding``,
    whose backward the training forward takes). An int8 embedding
    gathers int8 rows and their row scales and dequantizes only those
    rows."""
    emb = params["embed"]
    idx = tokens.long()
    if q8.is_quantized_weight(emb):
        return (emb["q8"][idx].float() * emb["scale"][idx]).to(cfg.dtype)
    return F.embedding(idx, emb).to(cfg.dtype)


def _vocab_logits(x: torch.Tensor, params) -> torch.Tensor:
    """Tied vocab head in fp32: [N, D] -> [N, V]; an int8 embedding is
    dequantized to fp32 first."""
    emb = params["embed"]
    emb32 = (q8.dequantize_weight(emb) if q8.is_quantized_weight(emb)
             else emb.float())
    return x.float() @ emb32.T


def _mlp(h2, w_in, w_out):
    """The dense FFN, weights cast to the activations' dtype at use (a
    no-op on the serving dict)."""
    ff = F.gelu(h2 @ w_in.to(h2.dtype), approximate="tanh")
    return ff @ w_out.to(ff.dtype)


def _moe_weights(w):
    return {"gate": w["gate"], "w_in": w["moe_w_in"],
            "w_out": w["moe_w_out"]}


def _serve_ffn(w, h2, cfg: TransformerConfig):
    """The FFN of a serving step over rows h2 [N, D]: the dense mlp, or
    the MoE at the serving capacity (``serving_moe_cfg``: no drops)."""
    if not cfg.moe_experts:
        return _mlp(h2, w["mlp_in"], w["mlp_out"])
    return moe.moe_ffn(_moe_weights(w), h2, cfg.serving_moe_cfg())[0]


def _dropout(h: torch.Tensor, rate: float,
             generator: Optional[torch.Generator],
             sp: Optional["_Split"] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate
    (uniform draws from ``generator``, which must live on ``h``'s
    device) and scale the kept ones by 1 / (1 - rate). Given the
    :class:`_Split` of a forward, ``h`` is this rank's [b, t, ...]
    block: the uniforms are drawn for the GLOBAL [B, T, ...] activation
    and this rank's block of them is kept, as the JAX forward draws one
    global mask and shards it. So ranks whose generators are seeded
    alike draw the unsharded step's masks at any world size, and the
    ranks of one ``model`` group draw the same block."""
    if rate <= 0.0:
        return h
    shape = h.shape if sp is None else \
        (sp.nb * sp.b, sp.ns * sp.t) + tuple(h.shape[2:])
    u = torch.rand(shape, generator=generator, device=h.device)
    if sp is not None:
        u = u[sp.rows, sp.cols]
    return torch.where(u < 1.0 - rate, h / (1.0 - rate), 0.0).to(h.dtype)


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            mesh=None,
            lengths: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] fp32: the JAX forward
    with ``head="all"``. ``lengths`` [B] masks keys at or past each
    row's length (plain attention then, as in the JAX package);
    ``generator`` enables inverted dropout at ``cfg.dropout`` on the
    embedding and both residual branches of every block, drawn on the
    tokens' device — omit it for a deterministic forward.
    ``return_aux=True`` also returns the summed MoE load-balance loss
    (zero for dense configs): (logits, aux). The serving heads and the
    stacked k/v are :func:`_forward_impl`'s (through :func:`prefill` and
    :func:`prefill_into_slot`).

    With a ``mesh`` every rank runs its block of the step (SPMD, see
    :func:`param_shardings`): ``params`` in their stored layout (this
    rank's shards, DTensors, or whole leaves it slices), ``tokens`` and
    ``lengths`` global; the global logits come back on every rank.
    Each dropout site draws the mask of the global [B, T, D] activation
    from ``generator`` and keeps this rank's block, in the unsharded
    forward's order: if every rank's generator is seeded alike, the
    masks are the unsharded forward's at any world size."""
    return _forward_impl(params, tokens, cfg, mesh=mesh, lengths=lengths,
                         generator=generator, return_aux=return_aux)


HEADS = ("all", "last", "gather", "shard")


def _forward_impl(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
                  mesh=None,
                  lengths: Optional[torch.Tensor] = None,
                  return_kv: bool = False, head: str = "all",
                  gather_pos: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  return_aux: bool = False):
    """The forward of :func:`forward` with the JAX package's serving
    options. ``head`` picks the positions that feed the vocab head:
    ``"all"`` ([B, T, V]), ``"last"`` (position -1, [B, 1, V]: the
    lockstep prefill) or ``"gather"`` (position ``gather_pos[b]`` of row
    b, a [B] device tensor read on the device, [B, 1, V]: the slot
    prefill of a right-padded prompt, whose causal attention keeps the
    padding out of the real positions); ``"shard"`` is this rank's
    block of the logits under a ``mesh`` ([b, t, V / model]: the input
    of :func:`lm_loss`'s vocab-parallel cross-entropy), ``"all"``
    without one. ``return_kv`` also returns each layer's k and v after
    RoPE, stacked [L, B, T, Hkv, Dh] in ``cfg.dtype``: (logits, (k, v));
    ``return_aux`` also returns the summed MoE load-balance loss (a 0-d
    fp32 tensor, 0 for a dense config), last. ``params`` may be the
    int8-weight tree (module docstring): its layers dequantize one at a
    time and its embedding rows gather as codes; the serving dict and
    the training tree run the JAX forward's operations, casts at use
    included. ``cfg.remat`` "bf16" / "q8" wraps each block in
    ``ops/q8.q8_remat`` when no k/v is returned; ``cfg.moe_experts``
    makes every FFN the MoE at the training capacity
    (``cfg.moe_cfg()``), as the JAX forward does in its lockstep and
    slot prefills too.

    With a ``mesh`` (:func:`forward`) the same block runs on this rank's
    tokens (:class:`_Split`): Megatron's f/g around the split regions
    (``spmd.copy_to``: identity forward, all-reduce backward;
    ``spmd.reduce_from``: all-reduce forward), the qkv columns gathered
    on use (the [q|k|v] column shards are not head-aligned), ring or
    all-to-all attention over ``seq`` (or the gathered global sequence
    without ``cfg.use_ring_attention``, :func:`_attention`), the
    embedding and the vocab head vocab-parallel over ``model``, the MoE
    over the gathered global tokens with experts over ``expert``, the
    dropout masks drawn globally (:func:`_dropout`). ``return_kv``
    gathers each layer's k / v whole, and the ``"last"`` / ``"gather"``
    heads gather the final hidden state over the token axes before they
    pick positions, so those come back global on every rank. Each
    collective is the identity where its axes span one rank, so a mesh
    of one rank runs the unsharded operations. The int8-weight tree is
    refused under a mesh, as the JAX forward takes none."""
    if head not in HEADS:
        raise ValueError(f"head {head!r}: one of {HEADS}")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"cfg.dropout must be in [0, 1), got {cfg.dropout}")
    rate = cfg.dropout if generator is not None else 0.0
    B, T = tokens.shape
    sp = _Split.of(mesh, cfg, B, T)
    if mesh is not None:
        if _tree_quantized(params):
            raise ValueError("the mesh path takes the float parameter tree")
        params = _local_params(params, cfg, mesh)
    b, t = sp.b, sp.t
    H, Dh, Hkv, D = cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.d_model
    Hl, Hkvl = H // sp.nm, Hkv // sp.nm
    dt = cfg.dtype
    tok = tokens[sp.rows, sp.cols]
    len_l = lengths[sp.rows] if lengths is not None else None
    x = _embed(params, tok, cfg, sp)
    pos0 = sp.isq * t
    if not cfg.use_rope:
        x = x + params["pos"][pos0:pos0 + t].to(dt)[None]
    x = _dropout(x, rate, generator, sp)
    rope_tabs = (_rope_tables(torch.arange(pos0, pos0 + t,
                                           device=tokens.device), Dh,
                              cfg.rope_theta) if cfg.use_rope else None)
    if _blocks_quantized(params):
        def layer(li):
            return _layer_weights(params["blocks"], li, dt)
    else:
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once instead of adding L full-size zero tensors
        w = {k: v.unbind(0) for k, v in params["blocks"].items()}

        def layer(li):
            return {k: v[li] for k, v in w.items()}

    def block(x, wl):
        h = norm.layer_norm(x, wl["ln1"], wl["ln1_b"])
        h = spmd.copy_to(h, mesh, sp.model)
        qkv = h @ _qkv_columns(wl["qkv"], cfg, sp).to(h.dtype)
        q, k, v = torch.split(qkv, [Hl * Dh, Hkvl * Dh, Hkvl * Dh], dim=-1)
        q = q.reshape(b, t, Hl, Dh)
        k = k.reshape(b, t, Hkvl, Dh)
        v = v.reshape(b, t, Hkvl, Dh)
        if cfg.use_rope:
            q, k = _rope(q, rope_tabs), _rope(k, rope_tabs)
        kv = (sp.gather(k.to(dt)), sp.gather(v.to(dt))) if return_kv \
            else None
        attn = _attention(q, k, v, cfg, sp, len_l)
        attn = attn.reshape(b, t, Hl * Dh)
        y = spmd.reduce_from(attn @ wl["attn_out"].to(attn.dtype), mesh,
                             sp.model)
        x = x + _dropout(y, rate, generator, sp)
        h2 = norm.layer_norm(x, wl["ln2"], wl["ln2_b"])
        if cfg.moe_experts:
            # routing capacity is over the GLOBAL tokens, as in the JAX
            # forward: gather them (the gather's backward reduce-scatters)
            hg = _gathered_tokens(h2, mesh, sp.bax, sp.seq)
            out, aux = moe.moe_ffn(_moe_weights(wl), hg.reshape(B * T, D),
                                   cfg.moe_cfg(), mesh=mesh)
            out = out.reshape(B, T, D)[sp.rows, sp.cols]
            x = x + _dropout(out.to(x.dtype), rate, generator, sp)
            return x, kv, aux
        h2 = spmd.copy_to(h2, mesh, sp.model)
        y = spmd.reduce_from(_mlp(h2, wl["mlp_in"], wl["mlp_out"]), mesh,
                             sp.model)
        return x + _dropout(y, rate, generator, sp), kv, None

    if cfg.remat != "none" and not return_kv:
        # layer-granular recompute: the backward rebuilds each block,
        # its collectives included, from a (quantized) copy of its
        # input, redrawing its dropout masks (k/v-returning calls are
        # serving-only: no backward)
        remat = q8.q8_remat(lambda x_, w_: block(x_, w_)[::2],
                            stash="int8" if cfg.remat == "q8" else "bf16")

        def run(x, wl):
            x, aux = remat(x, wl, generator=generator if rate > 0.0
                           else None)
            return x, None, aux
    else:
        run = block
    ks, vs, auxs = [], [], []
    for li in range(cfg.n_layers):
        x, kv, aux = run(x, layer(li))
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
        if aux is not None:
            auxs.append(aux)
    aux_total = (torch.stack(auxs).sum() if auxs else
                 torch.zeros((), dtype=torch.float32, device=x.device))
    if head in ("last", "gather"):
        # the positions are global: the [B, T, D] hidden state on every
        # rank first (it is replicated over ``model`` already)
        x = sp.gather(x, model=False)
        if head == "last":
            x = x[:, -1:]
        else:
            idx = gather_pos.long().clamp(0, T - 1).reshape(B, 1, 1)
            x = x.gather(1, idx.expand(B, 1, x.shape[-1]))
    x = norm.layer_norm(x, params["ln_f"], params["ln_f_b"])
    logits = _vocab_logits(spmd.copy_to(x, mesh, sp.model), params)
    if head == "all":
        logits = sp.gather(logits)
    elif head != "shard":
        logits = spmd.gather_replicated(logits, mesh, sp.model, 2)
    out = (logits,)
    if return_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    if return_aux:
        out += (aux_total,)
    return out[0] if len(out) == 1 else out


def lm_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: TransformerConfig, *, mesh=None,
            lengths: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the valid positions (all of
    them, or those before each row's ``lengths``), plus the MoE
    load-balance loss (0 for a dense config): a 0-d fp32 tensor.

    With a ``mesh`` (:func:`forward`): the global loss on every rank,
    the vocab head's cross-entropy vocab-parallel over ``model``. Its
    backward leaves each rank the gradient of its own tokens' share:
    :func:`sync_grads` sums them over the batch and sequence axes. With
    a ``generator`` seeded alike on every rank, the dropout masks, and
    so the loss and the synced gradients, are the unsharded step's."""
    B, T = tokens.shape
    sp = _Split.of(mesh, cfg, B, T)
    logits, aux = _forward_impl(params, tokens, cfg, mesh=mesh,
                                lengths=lengths, generator=generator,
                                head="shard", return_aux=True)
    tgt = targets[sp.rows, sp.cols]
    if sp.nm == 1:
        # the whole vocab is here: the unsharded loss's own operations
        ce = ops_loss.softmax_cross_entropy(logits, tgt)
    else:
        # vocab-parallel cross-entropy over this rank's vocab rows
        Vl = logits.shape[-1]
        tgt = tgt.long() - sp.im * Vl
        mx = logits.detach().amax(dim=-1)
        mx = spmd.all_reduce(mx, mesh, sp.model, op="max", tag="activation")
        se = spmd.reduce_from(
            torch.exp(logits - mx[..., None]).sum(dim=-1), mesh, sp.model)
        t_in = (tgt >= 0) & (tgt < Vl)
        picked = logits.gather(-1, tgt.clamp(0, Vl - 1)[..., None])[..., 0]
        picked = spmd.reduce_from(picked * t_in, mesh, sp.model)
        ce = mx + torch.log(se) - picked
    if lengths is not None:
        pos = torch.arange(sp.isq * sp.t, (sp.isq + 1) * sp.t,
                           device=ce.device)
        mask = (pos[None, :]
                < lengths[sp.rows].to(ce.device)[:, None]).float()
    else:
        mask = torch.ones_like(ce)
    count = spmd.all_reduce(mask.sum().detach(), mesh, sp.tok_axes,
                            tag="count")
    part = (ce * mask).sum() / count.clamp_min(1.0)
    # every token-split rank computed the same aux: each carries its
    # share, so the summed gradient counts it once
    part = part + aux / (sp.nb * sp.ns)
    return spmd.reduce_from(part, mesh, sp.tok_axes)


# ---------------------------------------------------------------------------
# the mesh path: DP x SP x TP (x EP) as one SPMD program per rank
# ---------------------------------------------------------------------------

def _global_shapes(cfg: TransformerConfig) -> Dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    kvd = cfg.kv_heads * cfg.head_dim
    blocks = {"ln1": (L, D), "ln1_b": (L, D), "ln2": (L, D),
              "ln2_b": (L, D), "qkv": (L, D, D + 2 * kvd),
              "attn_out": (L, D, D)}
    if cfg.moe_experts:
        E = cfg.moe_experts
        blocks.update(gate=(L, D, E), moe_w_in=(L, E, D, cfg.d_ff),
                      moe_w_out=(L, E, cfg.d_ff, D))
    else:
        blocks.update(mlp_in=(L, D, cfg.d_ff), mlp_out=(L, cfg.d_ff, D))
    return {"embed": (V, D), "pos": (cfg.max_len, D), "ln_f": (D,),
            "ln_f_b": (D,), "blocks": blocks}


def param_shardings(cfg: TransformerConfig, mesh) -> Dict:
    """The TP layout (scaling-book): qkv / mlp_in column-parallel,
    attn_out / mlp_out row-parallel over ``model``; the embedding
    vocab-sharded over ``model``; MoE experts over ``expert``. An axis
    the mesh does not carry degrades to replication. A tree of
    ``parallel.spmd.Layout``s in the parameter tree's structure."""
    from paddle_tpu_torch.parallel.spmd import Layout, P
    names = mesh.mesh_dim_names
    M = place.AXIS_MODEL if place.AXIS_MODEL in names else None

    def lay(*spec):
        return Layout(mesh, P(*spec))

    if cfg.moe_experts:
        E = place.AXIS_EXPERT if place.AXIS_EXPERT in names else None
        ffn = {"gate": lay(), "moe_w_in": lay(None, E, None, None),
               "moe_w_out": lay(None, E, None, None)}
    else:
        ffn = {"mlp_in": lay(None, None, M), "mlp_out": lay(None, M, None)}
    return {"embed": lay(M, None), "pos": lay(), "ln_f": lay(),
            "ln_f_b": lay(),
            "blocks": {"ln1": lay(), "ln1_b": lay(), "ln2": lay(),
                       "ln2_b": lay(), "qkv": lay(None, None, M),
                       "attn_out": lay(None, M, None), **ffn}}


def shard_params(params: Dict, cfg: TransformerConfig, mesh,
                 trainable: bool = False) -> Dict:
    """This rank's shards of a global parameter tree in the
    :func:`param_shardings` layout (plain tensors; ``trainable`` makes
    each an fp32 leaf that requires grad)."""
    lays = param_shardings(cfg, mesh)

    def leaf(t, lay):
        out = lay.shard(t.detach()).clone()
        if trainable:
            out = out.float().requires_grad_(True)
        return out

    out = {k: leaf(v, lays[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: leaf(v, lays["blocks"][k])
                     for k, v in params["blocks"].items()}
    return out


def sync_grads(grads: Dict, cfg: TransformerConfig, mesh) -> Dict:
    """Sum a rank's parameter gradients of :func:`lm_loss` (``mesh=``)
    over the axes that split tokens (``dcn``, ``data``, ``seq``): the
    gradient of the global loss, on every rank, in the stored layout."""
    from paddle_tpu_torch.parallel import spmd
    axes = tuple(a for a in ("dcn", place.AXIS_DATA, place.AXIS_SEQ)
                 if a in mesh.mesh_dim_names)
    seen: set = set()

    def red(g):
        return spmd.all_reduce(g, mesh, axes, tag="grad",
                               inplace=spmd.owned(g, seen))

    out = {k: red(grads[k]) for k in sorted(grads) if k != "blocks"}
    if "blocks" in grads:
        out["blocks"] = {k: red(grads["blocks"][k])
                         for k in sorted(grads["blocks"])}
    return out


def _local_leaf(t, lay, gshape):
    """A stored leaf as this rank's shard: a DTensor's local tensor, a
    whole (global-shaped) leaf sliced (its gradient lands on the slice),
    or a shard as it is."""
    from paddle_tpu_torch.parallel import spmd
    if spmd.is_sharded(t):
        return t.to_local()
    if lay.is_fully_replicated or tuple(t.shape) != tuple(gshape):
        return t
    return t[lay.local_slices(t.shape)]


@dataclasses.dataclass(frozen=True)
class _Split:
    """This rank's block of a forward over ``mesh``: tokens split over
    the batch axes ``bax`` (``dcn``, ``data``) and ``seq``, heads, FFN
    and vocab over ``model`` (``nb``, ``ns``, ``nm`` ranks; this rank at
    ``ib``, ``isq``, ``im``), ``b`` x ``t`` tokens of the global B x T.
    An axis the mesh lacks is None; without a mesh the split is the
    whole step."""
    mesh: object
    bax: tuple
    seq: Optional[str]
    model: Optional[str]
    nb: int
    ns: int
    nm: int
    ib: int
    isq: int
    im: int
    b: int
    t: int

    @classmethod
    def of(cls, mesh, cfg: TransformerConfig, B: int, T: int) -> "_Split":
        if mesh is None:
            return cls(None, (), None, None, 1, 1, 1, 0, 0, 0, B, T)
        names = mesh.mesh_dim_names
        bax = tuple(a for a in ("dcn", place.AXIS_DATA) if a in names)
        seq = place.AXIS_SEQ if place.AXIS_SEQ in names else None
        mod = place.AXIS_MODEL if place.AXIS_MODEL in names else None
        nb = spmd.axis_size(mesh, bax)
        ns = spmd.axis_size(mesh, seq)
        nm = spmd.axis_size(mesh, mod)
        if cfg.n_heads % nm or cfg.kv_heads % nm:
            raise ValueError(f"model axis {nm} must divide n_heads="
                             f"{cfg.n_heads} and kv_heads={cfg.kv_heads}")
        if B % nb or T % ns:
            raise ValueError(
                f"tokens [{B}, {T}] do not split over the batch axes {bax} "
                f"({nb} ranks) and {seq} ({ns} ranks): B must be a "
                f"multiple of {nb} and T of {ns}")
        return cls(mesh, bax, seq, mod, nb, ns, nm,
                   spmd.axis_index(mesh, bax), spmd.axis_index(mesh, seq),
                   spmd.axis_index(mesh, mod), B // nb, T // ns)

    @property
    def rows(self) -> slice:
        return slice(self.ib * self.b, (self.ib + 1) * self.b)

    @property
    def cols(self) -> slice:
        return slice(self.isq * self.t, (self.isq + 1) * self.t)

    @property
    def tok_axes(self) -> tuple:
        return self.bax + ((self.seq,) if self.seq else ())

    def gather(self, x, model: bool = True):
        """This rank's [b, t, X / model, ...] block (the logits, a
        layer's k / v) -> the global [B, T, X, ...] value on every rank;
        with ``model`` False, a [b, t, ...] block replicated over
        ``model`` (the hidden state) -> [B, T, ...]."""
        if model:
            x = spmd.gather_replicated(x, self.mesh, self.model, 2)
        x = spmd.gather_replicated(x, self.mesh, self.seq, 1)
        for a in reversed(self.bax):
            x = spmd.gather_replicated(x, self.mesh, a, 0)
        return x


def _local_params(params: Dict, cfg: TransformerConfig, mesh) -> Dict:
    """The tree of this rank's shards (:func:`_local_leaf`)."""
    lays = param_shardings(cfg, mesh)
    gsh = _global_shapes(cfg)
    out = {k: _local_leaf(params[k], lays[k], gsh[k])
           for k in ("embed", "pos", "ln_f", "ln_f_b")}
    out["blocks"] = {k: _local_leaf(v, lays["blocks"][k], gsh["blocks"][k])
                     for k, v in params["blocks"].items()}
    return out


def _whole_leaf(t, lay, gshape):
    """:func:`_local_leaf`'s inverse: a DTensor or a plain shard of the
    :func:`param_shardings` layout all-gathered whole, a whole leaf as
    it is."""
    if spmd.is_sharded(t):
        return spmd.full(t, tag="param")
    if lay.is_fully_replicated or tuple(t.shape) == tuple(gshape):
        return t
    return spmd.full(spmd.as_dtensor(t.contiguous(), lay, gshape),
                     tag="param")


def _whole_params(params: Dict, cfg: TransformerConfig, mesh) -> Dict:
    """The whole tree on every rank, from a tree in any stored layout a
    mesh forward takes (:func:`_whole_leaf`)."""
    lays = param_shardings(cfg, mesh)
    gsh = _global_shapes(cfg)
    out = {k: _whole_leaf(params[k], lays[k], gsh[k])
           for k in ("embed", "pos", "ln_f", "ln_f_b")}
    out["blocks"] = {k: _whole_leaf(v, lays["blocks"][k], gsh["blocks"][k])
                     for k, v in params["blocks"].items()}
    return out


def _embed(params, tok: torch.Tensor, cfg, sp: _Split) -> torch.Tensor:
    """The token embedding of this rank's tokens: :func:`_embed_rows`,
    or vocab-parallel over ``model`` (each rank gathers the rows it
    holds, zeros elsewhere, summed over the axis)."""
    if sp.nm == 1:
        return _embed_rows(params, tok, cfg)
    emb = params["embed"]
    Vl = emb.shape[0]
    idx = tok.long() - sp.im * Vl
    inside = (idx >= 0) & (idx < Vl)
    x = F.embedding(idx.clamp(0, Vl - 1), emb) * inside[..., None]
    return spmd.reduce_from(x, sp.mesh, sp.model).to(cfg.dtype)


def _qkv_columns(w: torch.Tensor, cfg, sp: _Split) -> torch.Tensor:
    """A layer's qkv weight as this rank multiplies it: whole, or under
    a ``model`` split the stored column shard gathered on use and this
    rank's q, k and v head columns taken from it."""
    if sp.nm == 1:
        return w
    D, kvd, Dh = cfg.d_model, cfg.kv_heads * cfg.head_dim, cfg.head_dim
    Hl, Hkvl = cfg.n_heads // sp.nm, cfg.kv_heads // sp.nm
    w = spmd.gather_on_use(w.contiguous(), sp.mesh, sp.model, 1)
    q0, k0 = sp.im * Hl * Dh, sp.im * Hkvl * Dh
    return torch.cat([w[:, q0:q0 + Hl * Dh],
                      w[:, D + k0:D + k0 + Hkvl * Dh],
                      w[:, D + kvd + k0:D + kvd + k0 + Hkvl * Dh]], dim=1)


def _attention(q, k, v, cfg, sp: _Split, lengths):
    """Causal attention of this rank's [b, t, h, Dh] q/k/v: kernel 5/6
    (:func:`ops.kernels.attention.flash_attention`) or, with
    ``lengths``, :func:`parallel.ring.full_attention`; over a ``seq``
    split with ``cfg.use_ring_attention`` the ring (flash or plain) or
    the all-to-all engine, without it the global sequence (as the JAX
    forward lets GSPMD gather it): q, k and v gathered over ``seq``,
    attention over all T positions, this rank's t rows kept. That
    compute is ``ns``-fold redundant, as GSPMD's gather is; the gathers'
    backward reduce-scatters, summing the ranks' k / v gradients."""
    use_flash = lengths is None
    if sp.ns > 1 and not cfg.use_ring_attention:
        q, k, v = (spmd.gather_on_use(x.contiguous(), sp.mesh, sp.seq, 1)
                   for x in (q, k, v))
        out = (kattention.flash_attention(q, k, v, causal=True) if use_flash
               else ring.full_attention(q, k, v, causal=True,
                                        lengths=lengths))
        return out[:, sp.cols]
    if sp.ns > 1:
        with compat.bind_mesh(sp.mesh):
            if cfg.cp_mode == "alltoall":
                return _alltoall_local(q, k, v, sp.mesh, sp.seq, lengths,
                                       use_flash)
            if use_flash:
                return ring.ring_flash_attention(
                    q.contiguous(), k.contiguous(), v.contiguous(),
                    axis_name=sp.seq, causal=True)
            return ring.ring_attention(q, k, v, axis_name=sp.seq,
                                       causal=True, lengths=lengths)
    if use_flash:
        return kattention.flash_attention(q, k, v, causal=True)
    return ring.full_attention(q, k, v, causal=True, lengths=lengths)


def _gathered_tokens(h, mesh, bax, seq_axis):
    """[b, t, D] activations of every token-split rank -> [B, T, D] on
    each (all-gather forward, reduce-scatter of the gradient backward)."""
    if seq_axis:
        h = spmd.gather_on_use(h.contiguous(), mesh, seq_axis, 1)
    for a in reversed(bax):
        h = spmd.gather_on_use(h.contiguous(), mesh, a, 0)
    return h


def _alltoall_local(q, k, v, mesh, seq, lengths, use_flash):
    """The all-to-all engine on this rank's [b, t, h, D] shards."""
    P_ = spmd.axis_size(mesh, seq)
    if q.shape[2] % P_ or k.shape[2] % P_:
        raise ValueError(
            f"alltoall attention: seq axis size {P_} must divide both "
            f"n_heads and kv_heads on this rank ({q.shape[2]}, "
            f"{k.shape[2]}); use ring attention for head counts that "
            f"don't split")

    def scatter(x):
        return spmd.all_to_all_grad(x.contiguous(), mesh, seq, 2, 1)

    qg, kg, vg = scatter(q), scatter(k), scatter(v)
    if use_flash:
        out = kattention.flash_attention(qg, kg, vg, causal=True)
    else:
        out = ring.full_attention(qg, kg, vg, causal=True, lengths=lengths)
    return spmd.all_to_all_grad(out.contiguous(), mesh, seq, 1, 2)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    """The KV arena of the lockstep and slot steps, zeroed: {"k", "v"}
    each [L, batch, max_len, kv_heads, Dh] in the model dtype, one row
    per sequence (token-major, the v3 artifact's layout). Runs on the
    card unless ``device`` says otherwise."""
    device = place.resolve_device(device)
    shape = (cfg.n_layers, int(batch), int(max_len), cfg.kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def cache_from_numpy(cache: Dict, cfg: TransformerConfig,
                     device=None) -> Dict[str, torch.Tensor]:
    """A ``paddle_tpu`` arena as numpy ({"k", "v"}) as the port's, cast
    to ``cfg.dtype``."""
    device = place.resolve_device(device)
    return {n: torch.from_numpy(np.asarray(cache[n], np.float32).copy())
            .to(device=device, dtype=cfg.dtype).contiguous()
            for n in ("k", "v")}


def cache_to_numpy(cache: Dict) -> Dict[str, np.ndarray]:
    """An arena as fp32 numpy arrays (exact for bf16 values)."""
    return {n: cache[n].detach().to("cpu", torch.float32).numpy()
            for n in ("k", "v")}


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache_len: int, *, mesh=None):
    """Batched prompt ingestion: tokens [B, T] -> (logits at the last
    position [B, vocab] fp32, arena {"k", "v"} [L, B, cache_len, Hkv,
    Dh] holding the prompt's k/v at positions 0..T-1 and zeros after).
    The training forward's block (kernel 5 for attention) with the
    ``"last"`` head. Equal-length prompts only: the lockstep decode
    shares one position across the batch.

    With a ``mesh`` the forward runs as :func:`forward`'s mesh path
    (``params`` in their stored layout, ``tokens`` global on every
    rank); the k / v and the last hidden state are gathered, so every
    rank returns the same global logits and arena."""
    T = tokens.shape[1]
    if T > cache_len:
        raise ValueError(f"prefill: {T} prompt tokens exceed cache_len "
                         f"{cache_len}")
    logits, kv = _forward_impl(params, tokens, cfg, mesh=mesh,
                               return_kv=True, head="last")
    L, B = kv[0].shape[:2]
    cache = {}
    for n, t in zip(("k", "v"), kv):
        c = torch.zeros((L, B, int(cache_len)) + t.shape[3:],
                        dtype=t.dtype, device=t.device)
        c[:, :, :T] = t
        cache[n] = c
    return logits[:, 0], cache


def arena_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    attend: torch.Tensor) -> torch.Tensor:
    """One token per arena row attending over its row: q [B, Hkv, G, Dh]
    (G query heads per kv head), one layer's arena kc/vc [B, max_len,
    Hkv, Dh], attend [B, max_len] bool -> [B, Hkv, G, Dh] fp32.
    ``paddle_tpu``'s arena attention, operation for operation (XLA there,
    outside any Pallas kernel): fp32 q.k / sqrt(Dh) over every position,
    -1e30 where ``attend`` is false, softmax, p.v in fp32."""
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), kc.float()) \
        / math.sqrt(q.shape[-1])
    s = torch.where(attend[:, None, None, :], s, -1e30)
    return torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, dim=-1),
                        vc.float())


def _arena_rows(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                active: Optional[torch.Tensor], cfg: TransformerConfig):
    """One token per arena row: tokens [B] int, pos [B] (row b writes
    and attends at pos[b]), active [B] bool or None (every row writes)
    -> (logits [B, vocab] fp32, cache, updated in place).

    Each layer writes row b's new k/v at (b, pos[b]) with one indexed
    write (an inactive row writes back the bytes it reads there, at pos
    clamped to max_len - 1), then attends to positions <= pos[b] through
    :func:`arena_attention`, grouped-query in the product, cast to
    ``cfg.dtype``. No host sync and no data-dependent shape:
    capturable."""
    B = tokens.shape[0]
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    kvd, G = Hkv * Dh, H // Hkv
    max_len = cache["k"].shape[2]
    dev = tokens.device
    pos = pos.long()
    x = _embed_rows(params, tokens, cfg)
    if not cfg.use_rope:
        # clipped: an inactive row may stand one past the table
        x = x + params["pos"][pos.clamp(max=params["pos"].shape[0] - 1)
                              ].to(cfg.dtype)
    rope_tabs = (_rope_tables(pos, Dh, cfg.rope_theta) if cfg.use_rope
                 else None)
    rows = torch.arange(B, device=dev)
    wpos = pos.clamp(max=max_len - 1)
    attend = torch.arange(max_len, device=dev)[None, :] <= pos[:, None]
    keep = active[:, None, None] if active is not None else None
    for li in range(cfg.n_layers):
        w = _layer_weights(params["blocks"], li, cfg.dtype)
        kc, vc = cache["k"][li], cache["v"][li]   # [B, max_len, Hkv, Dh]
        h = norm.layer_norm(x, w["ln1"], w["ln1_b"])
        qkv = h @ w["qkv"]
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        if cfg.use_rope:
            q = _rope_rows(q.reshape(B, H, Dh), rope_tabs).reshape(B, H * Dh)
            k = _rope_rows(k.reshape(B, Hkv, Dh), rope_tabs).reshape(B, kvd)
        for dst, new in ((kc, k), (vc, v)):
            new = new.reshape(B, Hkv, Dh).to(dst.dtype)
            if keep is not None:
                new = torch.where(keep, new, dst[rows, wpos])
            dst[rows, wpos] = new
        attn = arena_attention(q.reshape(B, Hkv, G, Dh), kc, vc, attend)
        x = x + attn.reshape(B, cfg.d_model).to(cfg.dtype) @ w["attn_out"]
        h2 = norm.layer_norm(x, w["ln2"], w["ln2_b"])
        x = x + _serve_ffn(w, h2, cfg)
    x = norm.layer_norm(x, params["ln_f"], params["ln_f_b"])
    return _vocab_logits(x, params), cache


def decode_step(params, cache, tokens: torch.Tensor, pos,
                cfg: TransformerConfig):
    """One lockstep step: tokens [B] at position ``pos`` (an int, or a
    0-d tensor on the tokens' device that the caller may advance there)
    -> (logits [B, vocab] fp32, cache, updated in place). Every row
    writes its k/v at ``pos`` and attends to positions <= ``pos``; the
    arithmetic is :func:`decode_step_slots`' element for element, so at
    equal positions the two give bitwise the same logits and cache.
    ``params`` may be the int8-weight tree."""
    B = tokens.shape[0]
    if isinstance(pos, torch.Tensor):
        posv = pos.reshape(1).long().expand(B)
    else:
        posv = torch.full((B,), int(pos), dtype=torch.long,
                          device=tokens.device)
    return _arena_rows(params, cache, tokens, posv, None, cfg)


def decode_step_slots(params, cache, tokens: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      cfg: TransformerConfig):
    """One step with per-slot positions: tokens [B] int32, pos [B] int32,
    active [B] bool -> (logits [B, vocab] fp32, cache, updated in
    place). The continuous-batching step: every arena row advances at
    its own position; an inactive row computes, but no byte of the
    arena changes for it (it writes back what it reads), so admission
    and recycling never perturb a neighbour. Captured into a CUDA graph
    by the slot engine (``serving/sampling.engine_step_fns``)."""
    return _arena_rows(params, cache, tokens, pos, active, cfg)


def prefill_into_slot(params, cache, tokens: torch.Tensor, length, slot,
                      cfg: TransformerConfig, *, mesh=None):
    """Prefill ONE request into arena row ``slot``.

    tokens [1, Tb] is the prompt right-padded to its bucket; ``length``
    (the real prompt length) and ``slot`` are 0-d int32 tensors on the
    tokens' device (ints are taken too), so one captured program per
    bucket serves every length and slot. Returns (logits at position
    ``length - 1`` [1, vocab] fp32, cache): the forward runs with the
    ``"gather"`` head (causal attention keeps the padding out of the
    real positions), then the [L, 1, Tb, Hkv, Dh] k/v land in row
    ``slot`` at positions 0..Tb-1 with one ``index_copy_`` per array;
    every other row keeps its bytes. The padded positions' k/v are
    overwritten by decode steps before any mask lets them be read.

    With a ``mesh`` the forward is :func:`prefill`'s mesh path: the
    [1, Tb] prompt splits over the mesh as any batch does (so a batch
    axis of more than one rank raises, as the JAX function's sharding
    constraint does), and every rank writes the same row of its arena."""
    if tokens.shape[0] != 1:
        raise ValueError(f"prefill_into_slot takes one request "
                         f"([1, Tb] tokens), got {tuple(tokens.shape)}")
    dev = tokens.device
    Tb = tokens.shape[1]
    length = torch.as_tensor(length, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(slot, device=dev).long().reshape(1)
    logits, kv = _forward_impl(params, tokens, cfg, mesh=mesh,
                               return_kv=True, head="gather",
                               gather_pos=length.reshape(1) - 1)
    for n, t in zip(("k", "v"), kv):
        cache[n][:, :, :Tb].index_copy_(1, slot, t.to(cache[n].dtype))
    return logits[:, 0], cache


def _pool_layer(pool, li: int, kvq: str):
    """Layer ``li``'s views of the pool arrays and the kernels' keyword
    arguments for them: (k, v, {"k_scale", "v_scale", "kv_dtype"})."""
    scales = ({"k_scale": pool["k_scale"][li], "v_scale": pool["v_scale"][li]}
              if kvq != "none" else {})
    return pool["k"][li], pool["v"][li], dict(scales, kv_dtype=kvq)


def _paged_rows(params, pool, tokens: torch.Tensor, pos: torch.Tensor,
                live: torch.Tensor, pages: torch.Tensor,
                cfg: TransformerConfig, block_size: int):
    """The paged decode step over ``N = B * W`` rows: tokens [B, W]
    int32, row (b, j) at position ``pos[b] + j``, live [B, W] bool (the
    rows that write), pages [B, P] -> (logits [N, vocab] fp32, pool).

    Every live row's k/v is written before attention, then each row
    attends to its positions <= pos[b] + j through
    ``flash_decode_attention``, reading its slot's page-table row. There
    is no host sync and no shape that depends on the data, so it can be
    captured into a CUDA graph: every row takes part in one indexed write
    and a dead row takes the write row and values of the first live row
    (its page-table entries may be 0, and block 0 may belong to a live
    request: redirected, it writes the same bytes to the same place as
    that row, never other bytes beside it; duplicate indices of one write
    land in no fixed order). With no live row at all, every row rewrites
    row 0's target with the bytes already there. ``pos // block_size``
    of a dead row may pass P - 1: it is clamped before the gather.
    Learned positions clip at ``max_len - 1`` (dead rows only)."""
    B, W = tokens.shape
    N = B * W
    P = pages.shape[1]
    bs = int(block_size)
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    kvd, G = Hkv * Dh, H // Hkv
    kvq = pool_kv_dtype(pool, cfg)
    dev = tokens.device
    gpos = pos.long()[:, None] + torch.arange(W, device=dev)[None, :]
    flat_pos = gpos.reshape(N)
    x = _embed_rows(params, tokens.reshape(N), cfg)
    if not cfg.use_rope:
        x = x + params["pos"][flat_pos.clamp(max=params["pos"].shape[0] - 1)
                              ].to(cfg.dtype)
    rope_tabs = (_rope_tables(flat_pos, Dh, cfg.rope_theta) if cfg.use_rope
                 else None)
    live = live.reshape(N)
    pg = (gpos // bs).clamp(max=P - 1)
    wrow = (pages.long().gather(1, pg) * bs + gpos % bs).reshape(N)
    rows = torch.arange(N, device=dev)
    first = torch.where(live, rows, N).amin().clamp(max=N - 1)
    src = torch.where(live, rows, first)
    widx = wrow[src]
    any_live = live.any()
    # kernel 1's operands: each row reads its slot's page-table row (an
    # element-wise repeat, as repeat_interleave(W, 0), written as an
    # expand so no step input depends on a host read; a view for W = 1)
    row_pages = pages[:, None, :].expand(B, W, P).reshape(N, P)
    row_pos = flat_pos.to(torch.int32)

    def write(dst, new):
        """dst[:, widx] = new [Hkv, N, ...], or dst's own bytes there
        when no row is live."""
        dst[:, widx] = torch.where(any_live, new, dst[:, widx])

    for li in range(cfg.n_layers):
        w = _layer_weights(params["blocks"], li, cfg.dtype)
        kc, vc, kvkw = _pool_layer(pool, li, kvq)     # [Hkv, M, ...] views
        h = norm.layer_norm(x, w["ln1"], w["ln1_b"])
        qkv = h @ w["qkv"]
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        if cfg.use_rope:
            q = _rope_rows(q.reshape(N, H, Dh), rope_tabs).reshape(N, H * Dh)
            k = _rope_rows(k.reshape(N, Hkv, Dh), rope_tabs).reshape(N, kvd)
        k_new = k.reshape(N, Hkv, Dh)[src]
        v_new = v.reshape(N, Hkv, Dh)[src]
        if kvq != "none":
            kq, ks = q8.quantize_kv(k_new, kvq)
            vq, vs = q8.quantize_kv(v_new, kvq)
            write(kc, kq.transpose(0, 1))
            write(vc, vq.transpose(0, 1))
            write(kvkw["k_scale"], ks.transpose(0, 1))
            write(kvkw["v_scale"], vs.transpose(0, 1))
        else:
            write(kc, k_new.transpose(0, 1).to(kc.dtype))
            write(vc, v_new.transpose(0, 1).to(vc.dtype))
        attn = kdecode.flash_decode_attention(
            q.reshape(N, Hkv, G, Dh).contiguous(), kc, vc, row_pages,
            row_pos, block_size=bs, **kvkw)
        x = x + attn.reshape(N, cfg.d_model).to(cfg.dtype) @ w["attn_out"]
        h2 = norm.layer_norm(x, w["ln2"], w["ln2_b"])
        x = x + _serve_ffn(w, h2, cfg)
    x = norm.layer_norm(x, params["ln_f"], params["ln_f_b"])
    return _vocab_logits(x, params), pool


def decode_step_paged(params, pool, tokens: torch.Tensor,
                      pos: torch.Tensor, active: torch.Tensor,
                      pages: torch.Tensor, cfg: TransformerConfig, *,
                      block_size: int):
    """One decode step over the paged pool: tokens [B] int32, pos [B]
    int32, active [B] bool, pages [B, P] int32 -> (logits [B, vocab]
    fp32, pool). Active row b writes its new k/v at pool position
    ``pages[b, pos[b] // bs] * bs + pos[b] % bs`` (in place), then every
    row attends through ``flash_decode_attention``. Inactive rows change
    no byte of the pool — the JAX scatter drops them with
    ``mode="drop"``; here an inactive row rewrites the first active
    row's target with its bytes (``_paged_rows``), so the step has no
    host sync and can be captured into a CUDA graph.

    A quantized pool gets the new k/v quantized at write time
    (``ops/q8.quantize_kv`` on the model-dtype values after RoPE, one
    scale per (row, head)); values and scales follow the same rule, and
    attention reads through the kernel's quantized branch. ``params``
    may be the int8-weight tree (module docstring)."""
    return _paged_rows(params, pool, tokens[:, None], pos, active[:, None],
                       pages, cfg, block_size)


def verify_step_paged(params, pool, tokens: torch.Tensor, pos: torch.Tensor,
                      valid: torch.Tensor, active: torch.Tensor,
                      pages: torch.Tensor, cfg: TransformerConfig, *,
                      block_size: int):
    """W tokens of every slot in one pass over the paged pool, the
    speculative-decoding verify step: tokens [B, W] int32 (row b holds
    ``[last_token, draft_1, ..., draft_{W-1}]``), pos [B] int32 (where
    row b's first token writes, ``decode_step_paged``'s ``pos``), valid
    [B] int32 (window rows at or past it neither write nor matter),
    active [B] bool, pages [B, P] the full page table -> (logits
    [B, W, vocab] fp32, pool).

    This is :func:`decode_step_paged` over ``N = B * W`` rows (the same
    function, ``_paged_rows``): window row (b, j) stands at position
    ``pos[b] + j``. All W rows' k/v are written before attention, and row
    (b, j) attends to positions <= pos[b] + j, so it sees the rows before
    it in its own window and itself, as the sequential decode steps
    would. Attention is the decode step's own kernel reduction, which a
    slot computes bitwise the same whatever the batch; the dense ops are
    row-wise over [N, ...], but their GEMMs run at M = N where the decode
    step runs at M = B, so a window row equals its decode step within
    the library's rounding, bitwise only where the GEMM does not change
    with M.

    Rows at or past ``valid`` and inactive slots change no byte of the
    pool. Rejected draft rows' k/v do land in the pool: the engine
    rewinds ``pos``, the attention mask hides them and the next window
    overwrites them. A quantized pool and the int8-weight tree ride as
    in the decode step."""
    B, W = tokens.shape
    live = active[:, None] & (torch.arange(W, device=tokens.device)[None, :]
                              < valid.long()[:, None])
    logits, pool = _paged_rows(params, pool, tokens, pos, live, pages, cfg,
                               block_size)
    return logits.reshape(B, W, cfg.vocab), pool


def prefill_into_blocks(params, pool, tokens: torch.Tensor, length,
                        pages: torch.Tensor, cfg: TransformerConfig, *,
                        block_size: int):
    """Prefill ONE chunk of one prompt into its pool pages.

    tokens [1, C] is the chunk right-padded to its bucket; ``length``
    counts its valid tokens, a 0-d int32 tensor (as ``np.int32(c)`` is
    a traced scalar in the JAX package; an int is taken too), so one
    captured program serves every length of its bucket and nothing
    here waits on the device; pages [P] int32 covers context + chunk, the
    chunk on the last ``ceil(C / bs)`` pages, so the context already in
    the pool is ``S = (P - ceil(C / bs)) * bs`` tokens. Each layer's
    attention runs ``flash_chunk_prefill`` (context fully visible, chunk
    causal); after the layers, ``paged_span_write`` lands the chunk's
    K/V in its pages in place, valid rows only — padded rows map to
    unallocated page-table entries (0) and must never be written.
    Returns (logits at the last valid position [1, vocab] fp32, pool).

    A quantized pool: in-chunk attention uses the chunk's exact
    model-dtype K/V and only what lands in the pool is rounded — the
    spans are quantized after the layers, per (layer, token, head), and
    one span write covers values and scales. ``params`` may be the
    int8-weight tree (module docstring)."""
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
    kvq = pool_kv_dtype(pool, cfg)
    dev = tokens.device
    length = torch.as_tensor(length, dtype=torch.int32, device=dev)
    gpos = S + torch.arange(C, device=dev)
    x = _embed_rows(params, tokens[0], cfg)
    if not cfg.use_rope:
        # clip keeps padded rows (which never write) in range
        x = x + params["pos"][gpos.clamp(max=params["pos"].shape[0] - 1)
                              ].to(cfg.dtype)
    rope_tabs = (_rope_tables(gpos, Dh, cfg.rope_theta) if cfg.use_rope
                 else None)
    ctx_pages = pages[:P - pc]
    # the chunk's K/V in the pool's value dtype, or in the model dtype
    # until they are quantized after the layers
    span_dtype = cfg.dtype if kvq != "none" else pool["k"].dtype
    spans = {n: torch.zeros((cfg.n_layers, Hkv, pc * bs, Dh),
                            dtype=span_dtype, device=dev)
             for n in ("k", "v")}
    for li in range(cfg.n_layers):
        w = _layer_weights(params["blocks"], li, cfg.dtype)
        kc, vc, kvkw = _pool_layer(pool, li, kvq)
        h = norm.layer_norm(x, w["ln1"], w["ln1_b"])
        qkv = h @ w["qkv"]
        q, k, v = torch.split(qkv, [H * Dh, kvd, kvd], dim=-1)
        if cfg.use_rope:
            q = _rope_rows(q.reshape(C, H, Dh), rope_tabs).reshape(C, H * Dh)
            k = _rope_rows(k.reshape(C, Hkv, Dh), rope_tabs).reshape(C, kvd)
        kck = k.reshape(C, Hkv, Dh).contiguous()
        vck = v.reshape(C, Hkv, Dh).contiguous()
        attn = kprefill.flash_chunk_prefill(
            q.reshape(C, Hkv, G, Dh).contiguous(), kck, vck, kc, vc,
            ctx_pages, block_size=bs, **kvkw)
        spans["k"][li, :, :C] = kck.transpose(0, 1)
        spans["v"][li, :, :C] = vck.transpose(0, 1)
        x = x + attn.reshape(C, cfg.d_model).to(cfg.dtype) @ w["attn_out"]
        h2 = norm.layer_norm(x, w["ln2"], w["ln2_b"])
        x = x + _serve_ffn(w, h2, cfg)
    if kvq != "none":
        spans["k"], spans["k_scale"] = q8.quantize_kv(spans["k"], kvq)
        spans["v"], spans["v_scale"] = q8.quantize_kv(spans["v"], kvq)
    valid = torch.arange(pc * bs, device=dev) < length
    kprefill.paged_span_write(pool, spans, pages[P - pc:].contiguous(),
                              valid, block_size=bs, kv_dtype=kvq)
    # only the last valid position feeds the vocab head
    last = (length.long() - 1).clamp(min=0).reshape(1)
    x = norm.layer_norm(x.index_select(0, last), params["ln_f"],
                        params["ln_f_b"])
    return _vocab_logits(x, params), pool


def _check_lockstep(what: str, Tp: int, max_new: int,
                    cfg: TransformerConfig):
    if max_new < 1:
        raise ValueError(f"{what}: max_new must be >= 1, got {max_new}")
    if Tp + max_new > cfg.max_len:
        raise ValueError(f"{what}: {Tp + max_new} positions exceed "
                         f"cfg.max_len={cfg.max_len}")


def _mesh_prefill(params, prompt, cfg, cache_len, mesh):
    """The lockstep paths' prefill: (logits, arena, the tree the decode
    steps run on). Without a mesh, :func:`prefill` and ``params``. With
    one, :func:`prefill` under it (of the whole dequantized tree for an
    int8 tree, as the JAX function dequantizes it first) and the whole
    tree: the int8 tree as it is, a float tree gathered."""
    if mesh is None:
        return prefill(params, prompt, cfg, cache_len) + (params,)
    if _tree_quantized(params):
        live, whole = q8.dequantize_tree(params), params
    else:
        live, whole = params, _whole_params(params, cfg, mesh)
    return prefill(live, prompt, cfg, cache_len, mesh=mesh) + (whole,)


def generate(params, prompt: torch.Tensor, cfg: TransformerConfig, *,
             max_new: int, temperature: float = 0.0,
             key: Optional[torch.Tensor] = None,
             mesh=None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, Tp] -> [B, Tp + max_new]
    int32, on the prompt's device. :func:`prefill` fills an arena of
    ``Tp + max_new`` positions, then ``max_new - 1`` :func:`decode_step`
    calls extend it in place. ``temperature`` 0 is greedy (the
    first-index argmax); otherwise each token is
    ``jax.random.categorical(k, logits / temperature)`` under
    ``paddle_tpu``'s key chain (``key, k0 = split(key)`` for the first
    token, ``key, ks = split(key)`` before each step) with ``key`` from
    ``ops/prng.prng_key``, so the ids are JAX's on the CPU. The chain
    does not depend on the data: it is computed on the host up front,
    the noise on the prompt's device, and no step reads the device
    until the ids are returned. ``params`` may be the int8-weight tree
    (dequantized a layer at a time; the JAX function dequantizes the
    whole tree first, to the same bytes).

    ``mesh`` reaches :func:`prefill` only, as in the JAX function (an
    int8 tree is dequantized whole for it). The decode steps run
    unsharded on the whole tree, gathered once per call before the loop
    (:func:`_whole_params`), where the JAX decode runs partitioned under
    GSPMD: the same ids for more memory a rank. The key chain is the
    host's, so every rank returns the same ids."""
    B, Tp = prompt.shape
    _check_lockstep("generate", Tp, max_new, cfg)
    if temperature > 0 and key is None:
        raise ValueError("generate: sampling (temperature>0) needs a key")
    dev = prompt.device
    keys, temp = [None] * max_new, None
    if temperature > 0:                 # greedy reads no key
        chain = key.detach().cpu()
        for i in range(max_new):
            chain, keys[i] = prng.split(chain)
        temp = torch.full((1,), float(temperature), dtype=torch.float32,
                          device=dev)

    def sample(logits, k):
        if temp is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return prng.categorical(k, logits / temp).to(torch.int32)

    logits, cache, params = _mesh_prefill(params, prompt, cfg,
                                          Tp + max_new, mesh)
    toks = [sample(logits, keys[0])]
    for i in range(max_new - 1):
        logits, cache = decode_step(params, cache, toks[-1], Tp + i, cfg)
        toks.append(sample(logits, keys[i + 1]))
    return torch.cat([prompt.to(torch.int32), torch.stack(toks, dim=1)],
                     dim=1)


def beam_search(params, prompt: torch.Tensor, cfg: TransformerConfig, *,
                max_new: int, beam_size: int = 4, mesh=None):
    """Beam search over the arena: prompt [B, Tp] -> (tokens [B, K,
    Tp + max_new] int32, scores [B, K] fp32), best first, K =
    ``beam_size``. The prefill's log-softmax seeds K hypotheses per row;
    each step scores the K x V expansions, keeps the top K (ties to the
    lower index, as ``lax.top_k``), and gathers the arena rows of the
    surviving hypotheses; the tokens are recovered by walking the
    survivors' back-pointers. No length penalty: every hypothesis has
    ``max_new`` tokens. Scores are sums of fp32 log-probabilities.
    ``mesh`` reaches :func:`prefill` only, as in :func:`generate`."""
    B, Tp = prompt.shape
    _check_lockstep("beam_search", Tp, max_new, cfg)
    if beam_size < 1 or beam_size > cfg.vocab:
        raise ValueError(f"beam_search: beam_size {beam_size} must be in "
                         f"[1, vocab={cfg.vocab}]")
    K, V = int(beam_size), cfg.vocab
    dev = prompt.device
    logits, cache, params = _mesh_prefill(params, prompt, cfg,
                                          Tp + max_new, mesh)
    scores, toks = _top_k(torch.log_softmax(logits, dim=-1), K)
    cache = {n: c.repeat_interleave(K, dim=1) for n, c in cache.items()}
    toks = toks.to(torch.int32)
    base = torch.arange(B, device=dev)[:, None] * K
    hist = []
    for i in range(max_new - 1):
        logits, cache = decode_step(params, cache, toks.reshape(B * K),
                                    Tp + i, cfg)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        top, idx = _top_k((scores[:, :, None] + logp).reshape(B, K * V), K)
        src = idx // V
        flat = (base + src).reshape(B * K)
        cache = {n: c.index_select(1, flat) for n, c in cache.items()}
        hist.append((toks, src))
        toks, scores = (idx % V).to(torch.int32), top
    # hist[i] holds step i's tokens in the beam order before its
    # reshuffle and the map from the order after it back to that one:
    # walk each survivor's pointer back through the maps
    ptr = torch.arange(K, device=dev)[None].expand(B, K)
    seq = [toks]
    for t, src in reversed(hist):
        ptr = src.gather(1, ptr)
        seq.append(t.gather(1, ptr))
    seq = torch.stack(seq[::-1], dim=2)
    rep = prompt.to(torch.int32)[:, None, :].expand(B, K, Tp)
    return torch.cat([rep, seq], dim=2), scores
