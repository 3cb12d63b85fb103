"""Ring and all-to-all attention: exact attention over sequences sharded
across a mesh axis (counterpart of ``paddle_tpu/parallel/ring.py``).

Each rank holds a sequence shard of Q/K/V; K/V blocks rotate around the
ring (``spmd.ppermute``: ``batch_isend_irecv`` in the ring's order) while
an online-softmax accumulator folds in one block per step — memory stays
O(T/P) per rank and the result is exact attention.

- ``ring_attention``: the plain blocked engine with per-step masks
  (ragged ``lengths`` allowed), differentiated by autograd through the
  differentiable hop;
- ``ring_flash_attention``: each step runs kernel 5
  (``ops/kernels/attention.flash_block_fwd``); blocks fold by the
  logsumexp rule, and the backward re-walks the ring through kernel 6
  (``flash_block_bwd``) with the GLOBAL logsumexp. The diagonal block is
  causal, the others are full; a block wholly in the future is folded
  with lse = -1e30 forward and fed lse = +1e30 backward, so its
  p = exp(s - lse) is exactly 0 inside the kernel. dk/dv accumulators
  rotate with their block (group-summed to Hkv heads before each hop);
  K/V skip their last hop;
- ``ring_attention_spmd`` / ``alltoall_attention_spmd``: the
  ``shard_map`` wrappers over (batch, seq, heads);
- ``ring_flash_schedule``: the same forward and backward loops
  (``_ring_fwd`` / ``_ring_bwd``) over P virtual ranks in one process
  (the hop a rotation of the rank list) — how one card runs the ring.

The JAX package's ``block_q`` / ``block_k`` / ``interpret`` have no
counterpart: the CUDA kernels fix their own tiles.
"""

import math
from typing import Optional

import torch

from paddle_tpu_torch.core import place
from paddle_tpu_torch.parallel import compat, spmd
from paddle_tpu_torch.parallel.spmd import PartitionSpec as P

NEG_INF = -1e30


def _block_attn(q, k, v, mask, scale):
    """One blockwise piece -> (running max m [B,H,Tq], exp-sum l, the
    unnormalized out [B,Tq,H,D]); q [B,Tq,H,D] fp32, k/v [B,Tk,Hkv,D]."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.clamp_min(m, -1e29)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask[:, None, None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (m_safe.reshape(B, H, Tq), l.reshape(B, H, Tq),
            o.reshape(B, Tq, H, D))


def ring_attention(q, k, v, *, axis_name: str, causal: bool = False,
                   lengths: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None,
                   wire_int8: bool = False):
    """Exact attention with K/V rotating around the ``axis_name`` ring.
    Call inside ``shard_map``: q [B, T_local, H, D], k/v
    [B, T_local, Hkv, D]; ``lengths`` the global valid lengths [B].
    Returns [B, T_local, H, D] in q's dtype."""
    mesh = compat.current_mesh()
    B, Tl, H, D = q.shape
    n = spmd.axis_size(mesh, axis_name)
    my = spmd.axis_index(mesh, axis_name)
    scale = scale or (1.0 / math.sqrt(D))
    q32 = q.float()
    dev = q.device
    q_pos = my * Tl + torch.arange(Tl, device=dev)

    def step_mask(src):
        k_pos = src * Tl + torch.arange(Tl, device=dev)
        m = torch.ones((B, Tl, Tl), dtype=torch.bool, device=dev)
        if causal:
            m = m & (q_pos[None, :, None] >= k_pos[None, None, :])
        if lengths is not None:
            m = m & (k_pos[None, None, :] < lengths.to(dev)[:, None, None])
        return m

    perm = tuple((i, (i + 1) % n) for i in range(n))
    if wire_int8:
        from paddle_tpu_torch.ops import q8 as ops_q8
        send = ops_q8.make_ppermute_q8(axis_name, perm)
    else:
        def send(t):
            return spmd.ppermute_grad(t, mesh, axis_name, perm)

    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=dev)
    mx = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        bm, bl, bo = _block_attn(q32, k_cur, v_cur, step_mask(src), scale)
        new_m = torch.maximum(mx, bm)
        c_old = torch.exp(mx - new_m)
        c_new = torch.exp(bm - new_m)
        l = l * c_old + bl * c_new
        o = (o * c_old[..., None].transpose(1, 2)
             + bo * c_new[..., None].transpose(1, 2))
        mx = new_m
        if step < n - 1:
            k_cur, v_cur = send(k_cur), send(v_cur)
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None].transpose(1, 2)).to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   lengths: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with dense scores. q [B, T, H, D], k/v
    [B, T, Hkv, D] (H % Hkv == 0, grouped in the product, no repeated
    heads); ``lengths`` [B] masks keys at or past each row's length.
    Scores and softmax in fp32, masked entries -1e30 and their
    probabilities zeroed -> [B, T, H, D] in q's dtype."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qg = q.reshape(B, T, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = torch.ones((B, T, T), dtype=torch.bool, device=q.device)
    if causal:
        i = torch.arange(T, device=q.device)
        mask = mask & (i[None, :, None] >= i[None, None, :])
    if lengths is not None:
        mask = mask & (torch.arange(T, device=q.device)[None, None, :]
                       < lengths.to(q.device)[:, None, None])
    mask = mask[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


_FLASH_RAGGED_MSG = ("flash attention in context parallelism supports "
                     "packed equal-length sequences only; pass "
                     "lengths=None or use the plain engine "
                     "(use_flash=False)")


def _tp_axis(mesh, head_axis, H, Hkv, extra=1):
    names = mesh.mesh_dim_names
    if head_axis not in names:
        return None
    t = spmd.axis_size(mesh, head_axis)
    if t > 1 and H % (t * extra) == 0 and Hkv % (t * extra) == 0:
        return head_axis
    return None


def ring_attention_spmd(q, k, v, mesh, *, causal: bool = False,
                        lengths: Optional[torch.Tensor] = None,
                        batch_axis: str = place.AXIS_DATA,
                        seq_axis: str = place.AXIS_SEQ,
                        head_axis: str = place.AXIS_MODEL,
                        scale: Optional[float] = None,
                        use_flash: bool = False,
                        interpret=None,
                        wire_int8: bool = False):
    """``shard_map`` wrapper: global q/k/v [B, T, H, D] (k/v may carry
    Hkv < H heads) with B over ``batch_axis``, T over ``seq_axis`` and
    heads over ``head_axis`` when it divides both head counts; lengths
    [B] split with the batch. ``use_flash`` runs each ring step on
    kernels 5/6 (packed equal-length sequences only); ``wire_int8``
    sends the rotating K/V as int8 + a per-shard scale. ``interpret``
    is accepted for the JAX signature and ignored."""
    del interpret
    H, Hkv = q.shape[2], k.shape[2]
    tp = _tp_axis(mesh, head_axis, H, Hkv)
    qkv_spec = P(batch_axis, seq_axis, tp, None)
    if use_flash and lengths is not None:
        raise ValueError(_FLASH_RAGGED_MSG)
    if wire_int8 and lengths is not None:
        raise ValueError("wire_int8 supports packed equal-length "
                         "sequences only (padding would contaminate the "
                         "wire quantization scale); pass lengths=None")
    if lengths is None:
        if use_flash:
            def wrapped(q_, k_, v_):
                return ring_flash_attention(q_, k_, v_, axis_name=seq_axis,
                                            causal=causal, scale=scale,
                                            wire_int8=wire_int8)
        else:
            def wrapped(q_, k_, v_):
                return ring_attention(q_, k_, v_, axis_name=seq_axis,
                                      causal=causal, scale=scale,
                                      wire_int8=wire_int8)
        return compat.shard_map(wrapped, mesh=mesh, in_specs=(qkv_spec,) * 3,
                                out_specs=qkv_spec)(q, k, v)

    def wrapped_len(q_, k_, v_, len_):
        return ring_attention(q_, k_, v_, axis_name=seq_axis, causal=causal,
                              lengths=len_, scale=scale)
    return compat.shard_map(
        wrapped_len, mesh=mesh,
        in_specs=(qkv_spec, qkv_spec, qkv_spec, P(batch_axis)),
        out_specs=qkv_spec)(q, k, v, lengths)


def alltoall_attention_spmd(q, k, v, mesh, *, causal: bool = False,
                            lengths: Optional[torch.Tensor] = None,
                            batch_axis: str = place.AXIS_DATA,
                            seq_axis: str = place.AXIS_SEQ,
                            head_axis: str = place.AXIS_MODEL,
                            scale: Optional[float] = None,
                            use_flash: bool = False,
                            interpret=None):
    """All-to-all (Ulysses) sequence parallelism: one all-to-all
    reshuffles [B, T/P, H, D] into [B, T, H/P, D], attention runs
    locally per head group (kernel 5/6 with ``use_flash``, else the
    plain engine), and a second all-to-all restores sequence sharding.
    The seq-axis size (times any head-axis TP) must divide both head
    counts. Autograd transposes the all-to-alls."""
    del interpret
    P_ = spmd.axis_size(mesh, seq_axis)
    H, Hkv = q.shape[2], k.shape[2]
    tp = _tp_axis(mesh, head_axis, H, Hkv, extra=P_)
    denom = (spmd.axis_size(mesh, head_axis) if tp else 1) * P_
    if H % denom or Hkv % denom:
        raise ValueError(
            f"alltoall attention: seq axis size {P_} must divide both "
            f"n_heads={H} and kv_heads={Hkv}; use ring attention for "
            f"head counts that don't split")
    if use_flash and lengths is not None:
        raise ValueError(_FLASH_RAGGED_MSG)
    qkv_spec = P(batch_axis, seq_axis, tp, None)

    def local(q_, k_, v_, len_):
        m = compat.current_mesh()

        def scatter(t):
            return spmd.all_to_all_grad(t.contiguous(), m, seq_axis, 2, 1)

        def gather(t):
            return spmd.all_to_all_grad(t.contiguous(), m, seq_axis, 1, 2)

        qg, kg, vg = scatter(q_), scatter(k_), scatter(v_)
        if use_flash:
            from paddle_tpu_torch.ops.kernels.attention import \
                flash_attention
            out = flash_attention(qg, kg, vg, causal=causal, sm_scale=scale)
        else:
            out = full_attention(qg, kg, vg, causal=causal, lengths=len_,
                                 scale=scale)
        return gather(out)

    if lengths is None:
        return compat.shard_map(
            lambda a, b, c: local(a, b, c, None), mesh=mesh,
            in_specs=(qkv_spec,) * 3, out_specs=qkv_spec)(q, k, v)
    return compat.shard_map(
        local, mesh=mesh,
        in_specs=(qkv_spec, qkv_spec, qkv_spec, P(batch_axis)),
        out_specs=qkv_spec)(q, k, v, lengths)


# ---------------------------------------------------------------------------
# the flash ring: per-step functions, the rank driver and the schedule
# ---------------------------------------------------------------------------

def _bhtd(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _btHd(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def _expand_groups(kv_r, b, g):
    """[B·Hkv, T, D] -> [B·H, T, D], each kv head repeated g times (the
    local GQA broadcast after a hop; a fresh contiguous tensor)."""
    if g == 1:
        return kv_r
    bh, t, d = kv_r.shape
    return kv_r.reshape(b, bh // b, t, d).repeat_interleave(
        g, dim=1).reshape(bh * g, t, d)


def _group_sum(d_r, b, g):
    """[B·H, T, D] -> [B·Hkv, T, D]: the adjoint of ``_expand_groups``."""
    if g == 1:
        return d_r
    bh, t, d = d_r.shape
    return d_r.reshape(b, bh // (b * g), g, t, d).sum(dim=2).reshape(
        bh // g, t, d)


def _fold(o, lse, ob, lseb):
    """Combine two normalized partial attentions by logsumexp weights
    (fp32)."""
    m = torch.maximum(lse, lseb)
    w1 = torch.exp(lse - m)
    w2 = torch.exp(lseb - m)
    tot = torch.clamp_min(w1 + w2, 1e-30)
    o = (o * w1[..., None] + ob * w2[..., None]) / tot[..., None]
    return o, m + torch.log(tot)


# the block engines, (forward, backward): kernels 5 and 6, or their plain
# versions (which ``ring_flash_schedule`` holds the kernels against)
def _kernel_engines():
    from paddle_tpu_torch.ops.kernels import attention as ka
    return ka.flash_block_fwd, ka.flash_block_bwd


def _plain_engines():
    from paddle_tpu_torch.ops.kernels import attention as ka

    def fwd(q, k, v, scale, causal):
        return ka.flash_attention_fwd_plain(q, k, v, sm_scale=scale,
                                            causal=causal)

    def bwd(q, k, v, out, lse, do, scale, causal):
        return ka.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            sm_scale=scale, causal=causal)
    return fwd, bwd


def masked_lse(lse, src, my, causal):
    """The lse a step's backward feeds kernel 6: the global lse, or
    +1e30 for a block wholly in the future (p = exp(s - lse) is exactly
    0 inside the kernel; zeroing its output afterwards would turn an
    overflowed p into 0 * inf = NaN)."""
    if causal and not src < my:
        return torch.full_like(lse, -NEG_INF)
    return lse


def _ring_fwd(eng, qr, kr, vr, ranks, n, hop, scale, causal, b, g):
    """The flash ring's forward for the ring positions ``ranks`` of an
    ``n``-rank ring: lists, one entry per position, of q/k/v blocks
    [B·H(kv), T_local, D]. Step 0 is the diagonal block (the only causal
    one); at step s every position folds in the block of rank
    ``(r - s) % n`` (a block wholly in the future with lse = -1e30:
    weight 0), after ``hop`` has moved each list's blocks one rank on.
    Returns [(o fp32, lse)] per position."""
    fwd = eng[0]

    def blk(q_, k_, v_, c):
        o_, lse_ = fwd(q_, _expand_groups(k_, b, g),
                       _expand_groups(v_, b, g), scale, c)
        return o_.float(), lse_

    state = [blk(qr[i], kr[i], vr[i], causal) for i in range(len(ranks))]
    k_cur, v_cur = kr, vr
    for step in range(1, n):
        k_cur, v_cur = hop(k_cur), hop(v_cur)
        for i, r in enumerate(ranks):
            ob, lseb = blk(qr[i], k_cur[i], v_cur[i], False)
            if causal and not (r - step) % n < r:
                lseb = torch.full_like(lseb, NEG_INF)
            state[i] = _fold(*state[i], ob, lseb)
    return state


def _ring_bwd(eng, qr, kr, vr, outr, lse, dor, ranks, n, hop, rot, scale,
              causal, b, g, on_block=None):
    """The flash ring's backward for the positions ``ranks`` (lists as in
    :func:`_ring_fwd`, with the outputs, the GLOBAL lse and the output
    gradients): kernel 6 on each block with ``masked_lse``; dq stays,
    the dk/dv accumulators (group-summed to Hkv heads) travel with their
    block through ``rot``, K/V through ``hop``, skipping their last hop.
    ``on_block(phase, rank, src, (dq, dk, dv))`` sees every off-diagonal
    block's result. Returns the lists (dq, dk, dv), fp32."""
    bwd = eng[1]

    def blk(i, k_, v_, lse_, c):
        dq_, dk_, dv_ = bwd(qr[i], _expand_groups(k_, b, g),
                            _expand_groups(v_, b, g), outr[i], lse_,
                            dor[i], scale, c)
        return dq_.float(), _group_sum(dk_.float(), b, g), \
            _group_sum(dv_.float(), b, g)

    acc = [blk(i, kr[i], vr[i], lse[i], causal) for i in range(len(ranks))]
    dq, dk, dv = ([a[j] for a in acc] for j in range(3))
    if n > 1:
        k_cur, v_cur = hop(kr), hop(vr)
        dk, dv = rot(dk), rot(dv)
    for step in range(1, n):
        for i, r in enumerate(ranks):
            src = (r - step) % n
            dqb, dkb, dvb = blk(i, k_cur[i], v_cur[i],
                                masked_lse(lse[i], src, r, causal), False)
            if on_block is not None:
                on_block("bwd", r, src, (dqb, dkb, dvb))
            dq[i] = dq[i] + dqb
            dk[i] = dk[i] + dkb
            dv[i] = dv[i] + dvb
        if step < n - 1:                # K/V skip their last hop
            k_cur, v_cur = hop(k_cur), hop(v_cur)
        dk, dv = rot(dk), rot(dv)
    return dq, dk, dv


def _rank_hops(mesh, axis_name, wire_int8):
    """The rank's hops as list maps, for :func:`_ring_fwd` /
    :func:`_ring_bwd`: (K/V hop, int8 on the wire with ``wire_int8``;
    the dk/dv accumulators' hop), each sending to the next rank."""
    n = spmd.axis_size(mesh, axis_name)
    perm = tuple((i, (i + 1) % n) for i in range(n))
    if wire_int8:
        from paddle_tpu_torch.ops import q8 as ops_q8

        def kv(x):
            return ops_q8.ppermute_q8_raw(x, axis_name, perm, mesh=mesh)
    else:
        def kv(x):
            return spmd.ppermute(x, mesh, axis_name, perm, tag="kv")

    def acc(x):
        return spmd.ppermute(x, mesh, axis_name, perm, tag="dkv")
    return (lambda xs: [kv(x) for x in xs]), (lambda xs: [acc(x)
                                                          for x in xs])


class _RingFlash(torch.autograd.Function):
    """The flash ring on this rank: forward and backward walk the ring
    through kernels 5 and 6 (the JAX package's custom VJP), the loops of
    :func:`_ring_fwd` / :func:`_ring_bwd` over this rank's position."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale, wire_int8):
        B, Tl, H, D = q.shape
        G = H // k.shape[2]
        n = spmd.axis_size(mesh, axis_name)
        my = spmd.axis_index(mesh, axis_name)
        hop, _ = _rank_hops(mesh, axis_name, wire_int8)
        [(o, lse)] = _ring_fwd(_kernel_engines(), [_bhtd(q)], [_bhtd(k)],
                               [_bhtd(v)], [my], n, hop, scale, causal, B, G)
        out = _btHd(o, B, H).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis_name, causal, scale, wire_int8)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis_name, causal, scale, wire_int8 = ctx.args
        B, Tl, H, D = q.shape
        Hkv = k.shape[2]
        n = spmd.axis_size(mesh, axis_name)
        my = spmd.axis_index(mesh, axis_name)
        hop, rot = _rank_hops(mesh, axis_name, wire_int8)
        [dq], [dk], [dv] = _ring_bwd(
            _kernel_engines(), [_bhtd(q)], [_bhtd(k)], [_bhtd(v)],
            [_bhtd(out)], [lse], [_bhtd(do.to(q.dtype))], [my], n, hop,
            rot, scale, causal, B, H // Hkv)
        return (_btHd(dq, B, H).to(q.dtype),
                _btHd(dk, B, Hkv).to(k.dtype),
                _btHd(dv, B, Hkv).to(v.dtype),
                None, None, None, None, None)


def ring_flash_attention(q, k, v, *, axis_name: str, causal: bool = False,
                         scale: Optional[float] = None,
                         block_q=None, block_k=None, interpret=None,
                         wire_int8: bool = False):
    """Ring attention with kernel 5 as the per-block engine and kernel 6
    in its backward. Call inside ``shard_map``: q [B, T_local, H, D],
    k/v [B, T_local, Hkv, D]; equal-length (packed) sequences only."""
    del block_q, block_k, interpret
    scale = scale or (1.0 / math.sqrt(q.shape[3]))
    return _RingFlash.apply(q, k, v, compat.current_mesh(), axis_name,
                            bool(causal), float(scale), bool(wire_int8))


def ring_flash_schedule(q, k, v, P_: int, *, causal: bool = True,
                        scale: Optional[float] = None, do=None,
                        hop=None, on_block=None, engine: str = "kernel"):
    """The flash ring over ``P_`` virtual ranks in one process: q
    [B, T, H, D] and k/v [B, T, Hkv, D] are cut into P_ sequence shards
    and every position runs the loops ``_RingFlash`` runs
    (:func:`_ring_fwd`, then with ``do`` :func:`_ring_bwd`); a hop
    rotates the rank list (rank r receives from rank r - 1), with
    ``hop(x)`` applied to each travelling K/V block (identity by
    default: the wire codec goes there). ``engine`` "plain" runs the
    blocks on the plain versions of kernels 5 and 6; ``on_block`` is
    :func:`_ring_bwd`'s. Returns (out [B,T,H,D], lse [B·H, T]) and, with
    ``do``, (dq, dk, dv) whole."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    Tl = T // P_
    scale = scale or (1.0 / math.sqrt(D))
    eng = _plain_engines() if engine == "plain" else _kernel_engines()
    shard = [slice(r * Tl, (r + 1) * Tl) for r in range(P_)]
    ranks = list(range(P_))
    qr = [_bhtd(q[:, s]) for s in shard]
    kr = [_bhtd(k[:, s]) for s in shard]
    vr = [_bhtd(v[:, s]) for s in shard]
    codec = hop or (lambda x: x)

    def rot(xs):
        return [xs[(r - 1) % P_] for r in ranks]

    def kv_hop(xs):
        return [codec(x) for x in rot(xs)]

    state = _ring_fwd(eng, qr, kr, vr, ranks, P_, kv_hop, scale, causal,
                      B, G)
    outs = [_btHd(o, B, H).to(q.dtype) for o, _ in state]
    out = torch.cat(outs, dim=1)
    lses = [l for _, l in state]
    lse = torch.cat(lses, dim=1)
    if do is None:
        return out, lse
    dq, dk, dv = _ring_bwd(eng, qr, kr, vr, [_bhtd(o) for o in outs], lses,
                           [_bhtd(do[:, s].to(q.dtype)) for s in shard],
                           ranks, P_, kv_hop, rot, scale, causal, B, G,
                           on_block)
    return (out, lse,
            torch.cat([_btHd(x, B, H) for x in dq], dim=1).to(q.dtype),
            torch.cat([_btHd(x, B, Hkv) for x in dk], dim=1).to(k.dtype),
            torch.cat([_btHd(x, B, Hkv) for x in dv], dim=1).to(v.dtype))
