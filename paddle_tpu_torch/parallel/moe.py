"""Mixture-of-Experts feed-forward, its dense path (counterpart of
``paddle_tpu/parallel/moe.py``).

Tokens are routed by a learned gate to the top-k of E experts; dispatch
and combine are dense one-hot products over a fixed capacity per expert
(``int(capacity_factor * k * N / E)`` slots, Python arithmetic as in the
JAX package), so every shape is static and overflow tokens drop, as in
Switch; the load-balance aux loss keeps the router balanced. Routing is
all device work (no host read), so a step that runs it can be captured
into a CUDA graph.

The JAX products promote fp32 x bf16 to fp32: the gate, the dispatch,
the expert FFN and the combine all run in fp32 here too (the expert
weights are fp32 leaves), and the output is cast back to the tokens'
dtype.

With a mesh carrying an ``expert`` axis the experts shard over it
(``param_shardings``): ``moe_ffn(mesh=...)`` routes the global tokens
alike on every rank, runs this rank's experts on their slots and
all-gathers the expert outputs for the combine; ``moe_ffn_a2a`` is the
explicit-collective form (tokens split over the axis, dispatch and
combine by ``all_to_all``, optionally on the int8 wire).
"""

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.topk import top_k as _top_k


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    top_k: int = 1                  # 1 = Switch; 2 = GShard-style top-2
    normalize_gates: bool = True    # renormalize the k selected gates to
                                    # sum to 1 (GShard; ignored at k = 1)


def init_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """{"gate" [D, E], "w_in" [E, D, F], "w_out" [E, F, D]}: fp32 normal
    draws at the JAX package's scales (1/sqrt(D), 1/sqrt(D), 1/sqrt(F)),
    made on the CPU from ``generator`` and moved to ``device`` (the card
    unless told otherwise)."""
    from paddle_tpu_torch.core import place
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = 1.0 / math.sqrt(D)

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator) * scale

    dev = place.resolve_device(device)
    return {"gate": nrm((D, E), s).to(dev),
            "w_in": nrm((E, D, F_), s).to(dev),
            "w_out": nrm((E, F_, D), 1.0 / math.sqrt(F_)).to(dev)}


def param_shardings(cfg: MoEConfig, mesh):
    """Experts sharded over the ``expert`` axis; gate replicated."""
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel.spmd import Layout, P
    E = place.AXIS_EXPERT
    return {"gate": Layout(mesh, P()), "w_in": Layout(mesh, P(E, None, None)),
            "w_out": Layout(mesh, P(E, None, None))}


def _local_experts(w, mesh, axis, E):
    """This rank's experts of a stored leaf: a DTensor's shard, the
    rank's slice of a whole [E, ...] tensor, or a shard as it is."""
    from paddle_tpu_torch.parallel import spmd
    if spmd.is_sharded(w):
        return spmd.local(w)
    if w.shape[0] != E:
        return w                       # already this rank's experts
    n = spmd.axis_size(mesh, axis)
    i = spmd.axis_index(mesh, axis)
    return w[i * E // n:(i + 1) * E // n]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a comparison with a device arange, no host
    check of the indices (capturable)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(params, x: torch.Tensor, cfg: MoEConfig, cap: int):
    """Gating and capacity accounting: (disp [N, E, cap], combine
    [N, E, cap], frac [E], mean_p [E]). Choice c of every token claims
    its expert's capacity after all choices < c (the GShard priority
    rule: first choices never lose a slot to second choices); the
    dispatch one-hot sums over choices and the combine carries the
    per-choice gate weights on the same slots."""
    N = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = x.float() @ params["gate"].float()
    probs = torch.softmax(logits, dim=-1)                    # [N, E]
    gate_k, expert_k = _top_k(probs, k)                      # [N, k]
    if k > 1 and cfg.normalize_gates:
        gate_k = gate_k / torch.clamp_min(
            gate_k.sum(dim=-1, keepdim=True), 1e-9)
    # capacity over (choice-major, token) order
    oh_k = _one_hot(expert_k.T.reshape(k * N), E, torch.int32)  # [kN, E]
    pos = torch.cumsum(oh_k, dim=0, dtype=torch.int32) * oh_k - 1
    pos_in_expert = (pos * oh_k).sum(dim=1)                  # [kN]
    keep = pos_in_expert < cap
    slot_oh = _one_hot(pos_in_expert.clamp(0, cap - 1), cap, torch.float32)
    disp_k = oh_k.float()[:, :, None] * slot_oh[:, None, :]
    disp_k = torch.where(keep[:, None, None], disp_k, 0.0)
    disp_k = disp_k.reshape(k, N, E, cap)
    disp = disp_k.sum(dim=0)                                 # [N, E, cap]
    combine = torch.einsum("knec,nk->nec", disp_k, gate_k)
    # load-balance statistics: first choices drive balance
    frac = _one_hot(expert_k[:, 0], E, torch.float32).mean(dim=0)
    mean_p = probs.mean(dim=0)
    return disp, combine, frac, mean_p


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE feed-forward (k = 1: Switch; k = 2: GShard top-2):
    x [N, D] tokens -> (out [N, D] in x's dtype, aux loss, a 0-d fp32
    tensor). Each expert's FFN is gelu(x w_in) w_out over its ``cap``
    slots, a batched fp32 product; dropped tokens get 0. With a mesh
    carrying an ``expert`` axis every rank routes the (global) tokens
    alike, runs its own experts and all-gathers their outputs."""
    from paddle_tpu_torch.core import place
    ax = place.AXIS_EXPERT
    if mesh is not None and ax in mesh.mesh_dim_names:
        return _moe_ffn_ep(params, x, cfg, mesh, ax)
    N, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, num_experts={E}]")
    cap = max(1, int(cfg.capacity_factor * k * N / E))
    disp, combine, frac, mean_p = _route(params, x, cfg, cap)
    xe = torch.einsum("nec,nd->ecd", disp, x.float())        # [E, cap, D]
    h = F.gelu(torch.bmm(xe, params["w_in"].float()), approximate="tanh")
    ye = torch.bmm(h, params["w_out"].float())               # [E, cap, D]
    out = torch.einsum("nec,ecd->nd", combine, ye)
    # Switch eq. 4 / GShard l_aux: E * sum_e frac_e * mean_prob_e
    aux = cfg.aux_loss_weight * E * (frac * mean_p).sum()
    return out.to(x.dtype), aux


def _moe_ffn_ep(params, x, cfg, mesh, ax):
    from paddle_tpu_torch.parallel import spmd
    N, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, num_experts={E}]")
    cap = max(1, int(cfg.capacity_factor * k * N / E))
    gate = spmd.local(params["gate"])
    disp, combine, frac, mean_p = _route({"gate": gate}, x, cfg, cap)
    n = spmd.axis_size(mesh, ax)
    i = spmd.axis_index(mesh, ax)
    # the tokens enter a region split over the experts: their gradient
    # through the dispatch sums over the ranks (the routing's is whole)
    xd = spmd.copy_to(x, mesh, ax)
    xe = torch.einsum("nec,nd->ecd", disp, xd.float())       # [E, cap, D]
    xe = xe[i * E // n:(i + 1) * E // n]                    # my experts
    w_in = _local_experts(params["w_in"], mesh, ax, E)
    w_out = _local_experts(params["w_out"], mesh, ax, E)
    h = F.gelu(torch.bmm(xe, w_in.float()), approximate="tanh")
    ye = spmd.gather_replicated(torch.bmm(h, w_out.float()), mesh, ax, 0)
    out = torch.einsum("nec,ecd->nd", combine, ye)
    aux = cfg.aux_loss_weight * E * (frac * mean_p).sum()
    return out.to(x.dtype), aux


def moe_ffn_a2a(params, x, cfg: MoEConfig, mesh, wire_int8: bool = False):
    """MoE feed-forward in the explicit-collective form over the
    ``expert`` axis: the global tokens x [N, D] split over the axis
    (N/P per rank), capacity per (expert, source rank) —
    ``ceil(cf·k·N_s/E)`` slots, GShard's layout, so a rank cannot borrow
    another's unused slots — and ``all_to_all`` dispatch and combine.
    ``wire_int8``: both all-to-alls carry int8 codes + per-destination
    fp32 scales (``ops/q8.make_all_to_all_q8``), straight-through
    gradients. Returns the global (out [N, D], aux)."""
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import spmd
    ax = place.AXIS_EXPERT
    if ax not in mesh.mesh_dim_names:
        raise ValueError(f"mesh must carry an {ax!r} axis")
    pe = spmd.axis_size(mesh, ax)
    N, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, num_experts={E}]")
    if E % pe or N % pe:
        raise ValueError(f"num_experts={E} and N={N} must both be "
                         f"divisible by the expert axis size {pe}")
    e_local, n_s = E // pe, N // pe
    cap_s = max(1, int(math.ceil(cfg.capacity_factor * k * n_s / E)))
    if wire_int8:
        from paddle_tpu_torch.ops import q8 as ops_q8
        a2a = ops_q8.make_all_to_all_q8(ax, mesh=mesh)
    else:
        def a2a(v):
            return spmd.all_to_all_grad(v.contiguous(), mesh, ax, 0, 0)
    # the replicated gate's gradient sums over the ranks' token shards
    gate = spmd.copy_to(spmd.local(params["gate"]), mesh, ax)
    w_in = _local_experts(params["w_in"], mesh, ax, E)
    w_out = _local_experts(params["w_out"], mesh, ax, E)
    xs = spmd.slice_local(x, mesh, ax, 0)                    # [n_s, D]
    disp, combine, frac, mean_p = _route({"gate": gate}, xs, cfg, cap_s)
    xe = torch.einsum("nec,nd->ecd", disp, xs.float())
    xe = a2a(xe.reshape(pe, e_local, cap_s, D))      # leading: source
    xe = xe.transpose(0, 1).reshape(e_local, pe * cap_s, D)
    h = F.gelu(torch.bmm(xe, w_in.float()), approximate="tanh")
    ye = torch.bmm(h, w_out.float())
    ye = ye.reshape(e_local, pe, cap_s, D).transpose(0, 1)
    ye = a2a(ye).reshape(E, cap_s, D)                # back to the sources
    out = torch.einsum("nec,ecd->nd", combine, ye)
    # aux over the global balance statistics (equal token shards, so the
    # mean of the ranks' means is the full-batch mean)
    frac_g = spmd.mean_replicated(frac, mesh, ax)
    mean_p_g = spmd.mean_replicated(mean_p, mesh, ax)
    aux = cfg.aux_loss_weight * E * (frac_g * mean_p_g).sum()
    out = spmd.gather_replicated(out.to(x.dtype), mesh, ax, 0)
    return out, aux
