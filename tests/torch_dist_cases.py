"""The rank side of the port's multi-rank CPU tests: each ``case_*``
runs on every rank of ``tests/torch_dist_util.pool()`` and returns
numpy values (or plain Python) for the test to hold against the JAX
package. Imports only torch, numpy and the port."""

import sys

import numpy as np
import torch


class Ctx:
    def __init__(self, rank, world, inputs):
        self.rank, self.world, self.inputs = rank, world, inputs

    def t(self, name, dtype=None):
        a = torch.from_numpy(np.array(self.inputs[name]))
        return a.to(dtype) if dtype is not None else a


def _np(t):
    return t.detach().cpu().numpy()


def case_env(ctx):
    """What a rank sees: its index, the backend, jax not imported."""
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.core import place
    return {"rank": distributed.process_index(),
            "count": distributed.process_count(),
            "backend": distributed.backend(),
            "devices": place.device_count(),
            "jax": "jax" in sys.modules,
            "paddle_tpu": "paddle_tpu" in sys.modules,
            "threads": torch.get_num_threads()}


def case_collectives(ctx):
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import spmd
    mesh = place.make_mesh((2, 2), ("data", "model"))
    r = ctx.rank
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    with spmd.record_collectives() as rec:
        s = spmd.all_reduce(x, mesh, ("data", "model"))
        g = spmd.all_gather(x[None], mesh, "model", 0)
        rs = spmd.reduce_scatter(x, mesh, "data", 0)
        a2a = spmd.all_to_all(x.reshape(2, 2), mesh, "model")
        pp = spmd.ppermute(x, mesh, "data", ((0, 1), (1, 0)))
    return {"sum": _np(s), "gather": _np(g), "rs": _np(rs),
            "a2a": _np(a2a), "pp": _np(pp),
            "kinds": [e["kind"] for e in rec]}


def _mesh(shape, axes):
    from paddle_tpu_torch.core import place
    return place.make_mesh(tuple(shape), tuple(axes))


# ---------------------------------------------------------------------------
# distributed.py
# ---------------------------------------------------------------------------

def case_hybrid(ctx):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.parallel import compat, spmd
    P = spmd.P
    single = distributed.hybrid_mesh((2, 2), ("data", "model"),
                                     num_slices=1)
    out = {"single": place.mesh_shape(single)}
    try:
        distributed.hybrid_mesh((4,), ("data",), num_slices=3)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    mesh = distributed.hybrid_mesh((2,), ("data",))
    out["hybrid"] = place.mesh_shape(mesh)

    def f(x):
        s = spmd.all_reduce(x.sum(), compat.current_mesh(), ("dcn", "data"))
        return s
    ones = torch.ones(4)
    total = compat.shard_map(f, mesh=mesh, in_specs=P(("dcn", "data")),
                             out_specs=P())(ones)
    out["total"] = float(total)
    out["barrier_s"] = distributed.barrier("hybrid")
    return out


def case_lost_rank(ctx):
    """Rank 3 dies; the others wait on it in a collective."""
    import datetime
    import os

    import torch.distributed as dist
    g = dist.new_group(list(range(ctx.world)),
                       timeout=datetime.timedelta(seconds=5))
    if ctx.rank == ctx.world - 1:
        os._exit(3)
    x = torch.ones(1)
    dist.all_reduce(x, group=g)
    return float(x)


# ---------------------------------------------------------------------------
# the trainer under parallel= (tests/test_parallel.py, test_zero.py)
# ---------------------------------------------------------------------------

def mlp(P):
    L, A = P.layer, P.activation
    x = L.data("x", P.data_type.dense_vector(8))
    lbl = L.data("lbl", P.data_type.integer_value(3))
    h = L.fc(x, 16, act=A.Relu(), name="h")
    out = L.fc(h, 3, act=A.Softmax(), name="o")
    return L.classification_cost(out, lbl, name="cost")


def emb_net(P):
    L, A = P.layer, P.activation
    words = L.data("words", P.data_type.integer_value_sequence(40))
    lbl = L.data("lbl", P.data_type.integer_value(2))
    emb = L.embedding(words, 8, name="emb")
    pooled = L.pool(emb, name="pool")
    out = L.fc(pooled, 2, act=A.Softmax(), name="o")
    return L.classification_cost(out, lbl, name="cost")


def ctr_net(P, wide=1024, vocab=256):
    return P.models.ctr.ctr_wide_deep(wide, vocab, emb_dim=16,
                                      hidden=(32, 16))[1]


def bn_net(P):
    """An MLP with a batch norm layer (statistics over the batch)."""
    L, A = P.layer, P.activation
    x = L.data("x", P.data_type.dense_vector(8))
    lbl = L.data("lbl", P.data_type.integer_value(3))
    h = L.fc(x, 16, act=A.Linear(), name="h")
    h = L.batch_norm(h, act=A.Relu(), name="bn")
    out = L.fc(h, 3, act=A.Softmax(), name="o")
    return L.classification_cost(out, lbl, name="cost")


def convbn_net(P):
    """A fused conv + batch norm over 2x4x4 images (``img_conv_bn``)."""
    L, A = P.layer, P.activation
    x = L.data("x", P.data_type.dense_vector(32))
    lbl = L.data("lbl", P.data_type.integer_value(3))
    h = L.img_conv_bn(x, filter_size=3, num_filters=4, num_channels=2,
                      padding=1, act=A.Relu(), name="cb", img_size=4)
    out = L.fc(h, 3, act=A.Softmax(), name="o")
    return L.classification_cost(out, lbl, name="cost")


def q8_net(P, C=8, img=8, classes=5):
    """``tests/test_q8.py``'s q8 graph: a stem conv, the q8 entry, two
    q8 conv blocks, the q8 residual add and exit, an fc head."""
    L, A = P.layer, P.activation
    x = L.data("x", P.data_type.dense_vector(C * img * img))
    lbl = L.data("lbl", P.data_type.integer_value(classes))
    stem = L.img_conv(x, 3, C, num_channels=C, stride=1, padding=1,
                      act=A.Relu(), bias_attr=False, name="q8t_stem",
                      img_size=img)
    ent = L.q8_entry(stem, name="q8t_entry")
    c1 = L.img_conv_bn_q8(ent, 3, C, num_channels=C, stride=1, padding=1,
                          act=A.Relu(), name="q8t_1", conv_name="q8t_1_conv",
                          bn_name="q8t_1_bn")
    c2 = L.img_conv_bn_q8(c1, 3, C, num_channels=C, stride=1, padding=1,
                          act=None, name="q8t_2", conv_name="q8t_2_conv",
                          bn_name="q8t_2_bn")
    add = L.addto_q8([c2, ent], act=A.Relu(), name="q8t_add")
    ex = L.q8_exit(add, name="q8t_exit")
    out = L.fc(ex, classes, act=A.Softmax(), name="q8t_fc")
    return L.classification_cost(out, lbl, name="q8t_cost")


NETS = {"mlp": mlp, "emb": emb_net, "ctr": ctr_net, "bn": bn_net,
        "convbn": convbn_net, "q8": q8_net}


def optimizer(P, name):
    return {"sgd": lambda: P.optimizer.SGD(learning_rate=0.1),
            "momentum": lambda: P.optimizer.Momentum(momentum=0.9,
                                                     learning_rate=0.1),
            "adam": lambda: P.optimizer.Adam(learning_rate=0.05),
            "adam2": lambda: P.optimizer.Adam(learning_rate=1e-2),
            "momentum05": lambda: P.optimizer.Momentum(
                momentum=0.9, learning_rate=0.05)}[name]()


def _rows(ctx, net):
    if net in ("mlp", "bn", "convbn", "q8"):
        x, y = ctx.inputs["x"], ctx.inputs["y"]
        return [(x[i], int(y[i])) for i in range(len(y))]
    if net == "emb":
        w, y = ctx.inputs["words"], ctx.inputs["y"]
        return [([int(v) for v in w[i]], int(y[i])) for i in range(len(y))]
    import paddle_tpu_torch as T
    return list(T.models.ctr.synthetic_reader(1024, 256, n=256)())


def _cfg(mesh_shape, mesh_axes, zero=0, rules=(), zero_min_size=0):
    from paddle_tpu_torch.parallel import spmd
    mesh = _mesh(mesh_shape, mesh_axes)
    return spmd.DistConfig(mesh, param_rules=list(rules), zero_stage=zero,
                           zero_min_size=zero_min_size)


def _rules(names):
    import paddle_tpu_torch as T
    from paddle_tpu_torch.parallel import spmd
    out = []
    for kind, pattern in names:
        if kind == "ctr":
            out += T.models.ctr.ctr_dist_rules()
        else:
            out.append(getattr(spmd, kind)(pattern))
    return out


def case_train(ctx, net="mlp", opt="momentum", mesh_shape=(4,),
               mesh_axes=("data",), zero=0, accum=1, passes=2, batch=16,
               rules=(), ckdir=None, record=False, metrics_path=None,
               drop_last=True):
    """Train one of ``NETS`` from the JAX parameters (inputs ``p/<name>``)
    under ``parallel=``; returns the costs, the layouts and bytes, or the
    costs so far and the error when the trainer raises ValueError."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.parallel import spmd
    cost = NETS[net](T)
    params = T.parameters.create(cost, device="cpu")
    params.values = {k: ctx.t("p/" + k) for k in params.values}
    cfg = None
    if mesh_shape is not None:
        cfg = _cfg(mesh_shape, mesh_axes, zero, _rules(rules))
    tr = T.trainer.SGD(cost=cost, parameters=params,
                       update_equation=optimizer(T, opt), parallel=cfg,
                       grad_accum_steps=accum)
    rows = _rows(ctx, net)
    costs = []
    if metrics_path and ctx.rank == 0:
        observe.configure(metrics_path)
    rec_ctx = spmd.record_collectives() if record else None
    rec = rec_ctx.__enter__() if rec_ctx else None
    try:
        tr.train(reader=T.batch(lambda: iter(rows), batch,
                                drop_last=drop_last),
                 num_passes=passes, checkpoint_dir=ckdir,
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, T.event.EndIteration) else None)
    except ValueError as e:
        return {"costs": costs, "error": str(e)}
    finally:
        if rec_ctx:
            rec_ctx.__exit__(None, None, None)
        if metrics_path and ctx.rank == 0:
            observe.sink().flush()
            observe.configure(None)
    vals = tr.parameters.values
    out = {"costs": costs,
           "state": {k: _np(v) for k, v in tr.parameters.state.items()},
           "specs": {k: tuple(spmd.spec_of(v)) for k, v in vals.items()},
           "local_shapes": {k: tuple(spmd.local(v).shape)
                            for k, v in vals.items()},
           "opt_specs": {k: [tuple(spmd.spec_of(x)) for x in
                             (s if isinstance(s, (tuple, list)) else [s])
                             if isinstance(x, torch.Tensor)]
                         for k, s in tr.opt_state.items()},
           "opt_bytes": tr.opt_state_bytes_per_device(),
           "grad_bytes": tr.grad_bytes_per_device(),
           "param_bytes": tr.param_bytes_per_device(),
           "final": {k: _np(spmd.full(vals[k])) for k in sorted(vals)}}
    if cfg is not None:
        rep = cfg.zero_report({k: spmd.full(v) for k, v in vals.items()})
        out["report"] = {"sharded": sorted(rep["sharded"]),
                         "replicated": rep["replicated"],
                         "axis_size": rep["axis_size"]}
    if rec is not None:
        maxrep = max(int(np.prod(s)) * 4 for s in
                     (tuple(spmd.full(v).shape) for v in vals.values()))
        out["evidence"] = spmd.zero_collective_evidence(rec, maxrep)
        out["kinds"] = sorted({(r["kind"], r["tag"]) for r in rec})
    return out


def case_zero_policy(ctx):
    """The ZeRO policy on a (4,) data mesh and a (2, 2) data x model
    mesh, as plain tuples."""
    from paddle_tpu_torch.parallel import spmd
    P = spmd.P
    cfg = _cfg((4,), ("data",), 1)
    out = {"w816": cfg.zero_spec("w", (8, 16)),
           "w168": cfg.zero_spec("w", (16, 8)),
           "b16": cfg.zero_spec("b", (16,)),
           "b3": cfg.zero_spec("b", (3,)), "c": cfg.zero_spec("c", ()),
           "tiny": _cfg((4,), ("data",), 1, zero_min_size=64).zero_spec(
               "b", (16,)),
           "tiny_w": _cfg((4,), ("data",), 1, zero_min_size=64).zero_spec(
               "w", (8, 16)),
           "z0": _cfg((4,), ("data",), 0).zero_spec("w", (8, 16))}
    tp = _cfg((2, 2), ("data", "model"), 1,
              [spmd.fc_column_rule(r"^h\.w$")])
    out["tp"] = tp.zero_spec("h.w", (8, 16))
    out["tp_state"] = tp.state_shardings(
        {"h.w": np.zeros((8, 16), np.float32)})["h.w"].spec
    vals = {"h.w": torch.zeros(8, 16), "o.b": torch.zeros(3),
            "s": torch.zeros(())}
    rep = cfg.zero_report(vals)
    out["report"] = {"sharded": rep["sharded"],
                     "replicated": rep["replicated"],
                     "axis_size": rep["axis_size"]}
    for stage in (0, 1, 2, 3):
        c = _cfg((4,), ("data",), stage)
        out[f"grad{stage}"] = (c.grad_spec("w", (8, 16)),
                               c.grad_spec("w", (8, 16), accum=True))
        out[f"store{stage}"] = c.store_spec("w", (8, 16))
        out[f"rep{stage}"] = {k: (v if not isinstance(v, dict) else
                                  {"sharded": sorted(v["sharded"]),
                                   "replicated": v["replicated"]})
                              for k, v in c.zero_report(vals).items()
                              if k in ("grads", "params")}
    tp3 = _cfg((2, 2), ("data", "model"), 3,
               [spmd.fc_column_rule(r"^h\.w$")])
    out["tp3_store"] = tp3.store_spec("h.w", (8, 16))
    out["placements"] = [(type(p).__name__, getattr(p, "dim", None))
                         for p in spmd.Layout(tp.mesh, P(None, "model"))
                         .placements()]

    def plain(v):
        if isinstance(v, spmd.PartitionSpec):
            return tuple(plain(x) for x in v)
        if isinstance(v, tuple):
            return tuple(plain(x) for x in v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v
    return plain(out)


def case_save_sharded(ctx, path):
    """Save a DTensor row-sharded over 4 ranks (each rank its shard)."""
    from paddle_tpu_torch.io import checkpoint as ck
    from paddle_tpu_torch.parallel import spmd
    mesh = _mesh((4,), ("data",))
    full = ctx.t("x")
    stored = spmd.Layout(mesh, spmd.P("data", None)).stored(full)
    ck.save_checkpoint(path, 3, {"w": stored, "b": torch.arange(3.0)},
                       process_index=ctx.rank, process_count=ctx.world)
    return tuple(spmd.local(stored).shape)


def case_load_sharded(ctx, path):
    from paddle_tpu_torch.io import checkpoint as ck
    step, p, _, _ = ck.load_checkpoint(ck.latest_checkpoint(path),
                                       {"w": torch.zeros(4, 8)})
    return step, _np(p["w"])


# ---------------------------------------------------------------------------
# ring and all-to-all attention (tests/test_ring_transformer.py)
# ---------------------------------------------------------------------------

def case_attn(ctx, engine="ring", mesh_shape=(1, 4),
              mesh_axes=("data", "seq"), causal=False, use_lengths=False,
              use_flash=False, wire_int8=False, grads=False):
    """Global q/k/v (inputs) through the ring or all-to-all engine; the
    global output and, with ``grads``, the gradients of sum(out**2)."""
    from paddle_tpu_torch.parallel import ring
    mesh = _mesh(mesh_shape, mesh_axes)
    q, k, v = (ctx.t(n).requires_grad_(grads) for n in "qkv")
    lens = ctx.t("lens") if use_lengths else None
    kw = {"wire_int8": wire_int8} if engine == "ring" else {}
    fn = (ring.ring_attention_spmd if engine == "ring"
          else ring.alltoall_attention_spmd)
    try:
        out = fn(q, k, v, mesh, causal=causal, lengths=lens,
                 use_flash=use_flash, **kw)
    except ValueError as e:
        return {"error": str(e)}
    res = {"out": _np(out)}
    if grads:
        (out.float() ** 2).sum().backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return res


def _lm_cfg(kw):
    import paddle_tpu_torch.models.transformer as tt
    kw = dict(kw)
    kw["dtype"] = torch.float32
    return tt.TransformerConfig(**kw)


def _np_tree(ctx, prefix="p/"):
    tree = {"blocks": {}}
    for name, arr in ctx.inputs.items():
        if not name.startswith(prefix):
            continue
        key = name[len(prefix):]
        if key.startswith("blocks/"):
            tree["blocks"][key[len("blocks/"):]] = arr
        else:
            tree[key] = arr
    return tree


def case_lm(ctx, cfg, mesh_shape, mesh_axes, use_lengths=False,
            steps=0, lr=0.1, want="loss", hybrid=False):
    """The transformer's loss (and synced gradients) under a mesh from
    the JAX parameters; ``steps`` > 0 trains that many plain SGD steps
    and returns the losses."""
    import paddle_tpu_torch.models.transformer as tt
    from paddle_tpu_torch.parallel import spmd
    c = _lm_cfg(cfg)
    if hybrid:
        from paddle_tpu_torch import distributed
        mesh = distributed.hybrid_mesh(mesh_shape, mesh_axes)
    else:
        mesh = _mesh(mesh_shape, mesh_axes)
    full = tt.train_params_from_numpy(_np_tree(ctx), device="cpu")
    loc = tt.shard_params(full, c, mesh, trainable=True)
    toks, tgt = ctx.t("toks"), ctx.t("tgt")
    lens = ctx.t("lens") if use_lengths else None
    if want == "logits":
        logits = tt.forward(loc, toks, c, mesh=mesh, lengths=lens)
        return {"logits": _np(logits)}
    try:
        with spmd.record_collectives() as rec:
            loss = tt.lm_loss(loc, toks, tgt, c, mesh=mesh, lengths=lens)
    except ValueError as e:
        return {"error": str(e)}
    if steps:
        losses = []
        for _ in range(steps):
            loss = tt.lm_loss(loc, toks, tgt, c, mesh=mesh, lengths=lens)
            g = torch.autograd.grad(loss, [v for _, v in _leaves(loc)])
            names = [n for n, _ in _leaves(loc)]
            gt = {"blocks": {}}
            for n, gg in zip(names, g):
                if n.startswith("blocks/"):
                    gt["blocks"][n[7:]] = gg
                else:
                    gt[n] = gg
            gt = tt.sync_grads(gt, c, mesh)
            with torch.no_grad():
                for n, v in _leaves(loc):
                    gg = gt["blocks"][n[7:]] if n.startswith("blocks/") \
                        else gt[n]
                    v -= lr * gg
            losses.append(float(loss))
        from paddle_tpu_torch.core import place
        return {"losses": losses, "mesh": place.mesh_shape(mesh)}
    return {"loss": float(loss), "grads": _synced_grads(loss, loc, c, mesh),
            "kinds": sorted({(r["kind"], r["axis"]) for r in rec})}


def _leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [("blocks/" + k, v) for k, v in tree["blocks"].items()]


def _synced_grads(loss, loc, c, mesh):
    """{leaf name: (this rank's synced gradient, its slices of the
    global leaf)} of a mesh loss over the stored shards ``loc``."""
    import paddle_tpu_torch.models.transformer as tt
    lays, gsh = tt.param_shardings(c, mesh), tt._global_shapes(c)
    names = [n for n, _ in _leaves(loc)]
    g = torch.autograd.grad(loss, [v for _, v in _leaves(loc)])
    gt = {"blocks": {}}
    for n, gg in zip(names, g):
        if n.startswith("blocks/"):
            gt["blocks"][n[7:]] = gg
        else:
            gt[n] = gg
    gt = tt.sync_grads(gt, c, mesh)
    grads = {}
    for n in names:
        blk = n.startswith("blocks/")
        gg = gt["blocks"][n[7:]] if blk else gt[n]
        lay = lays["blocks"][n[7:]] if blk else lays[n]
        sl = lay.local_slices(gsh["blocks"][n[7:]] if blk else gsh[n])
        grads[n] = (_np(gg), [(s.start, s.stop) for s in sl])
    return grads


def case_wire(ctx):
    """The int8 wire collectives on the 4-rank ``seq`` ring: each rank's
    shard ``x[rank]`` hopped once, and ``y[rank]`` exchanged all-to-all;
    with the record of what crossed the wire."""
    from paddle_tpu_torch.ops import q8
    from paddle_tpu_torch.parallel import spmd
    mesh = _mesh((4,), ("seq",))
    x = ctx.t("x")[ctx.rank]
    y = ctx.t("y")[ctx.rank]
    perm = tuple((i, (i + 1) % 4) for i in range(4))
    with spmd.record_collectives() as rec:
        hop = q8.ppermute_q8_raw(x, "seq", perm, mesh=mesh)
        a2a = q8.all_to_all_q8_raw(y, "seq", mesh=mesh)
    codes, scale = q8.wire_encode(x)
    return {"hop": _np(hop), "a2a": _np(a2a), "codes": _np(codes),
            "scale": float(scale),
            "wire": [(r["kind"], r["tag"], r["bytes"]) for r in rec]}


def case_ring_wire_grads(ctx, use_flash=False):
    """ring_attention_spmd with the int8 wire: output and gradients."""
    return case_attn(ctx, "ring", (1, 4), ("data", "seq"), causal=True,
                     use_flash=use_flash, wire_int8=True, grads=True)


# ---------------------------------------------------------------------------
# MoE expert parallelism and pipelines (tests/test_moe_pipeline.py)
# ---------------------------------------------------------------------------

def case_moe(ctx, cfg, mesh_shape, mesh_axes, mode="ep", wire_int8=False,
             grads=False, steps=0, lr=0.1, store="dtensor"):
    """The MoE FFN on the mesh from the JAX parameters (inputs ``gate``,
    ``w_in``, ``w_out``, tokens ``x``): experts stored sharded over
    ``expert`` (DTensors, or whole leaves with ``store="whole"``)."""
    from paddle_tpu_torch.parallel import moe, spmd
    c = moe.MoEConfig(**cfg)
    mesh = _mesh(mesh_shape, mesh_axes)
    lays = moe.param_shardings(c, mesh)
    whole = {k: ctx.t(k) for k in ("gate", "w_in", "w_out")}
    need = bool(grads or steps)
    if store == "whole":
        params = {k: v.clone().requires_grad_(need)
                  for k, v in whole.items()}
        loc = params
    else:
        loc = {k: lays[k].shard(v).clone().requires_grad_(need)
               for k, v in whole.items()}
        params = {k: (spmd.as_dtensor(loc[k], lays[k], whole[k].shape)
                      if not lays[k].is_fully_replicated else loc[k])
                  for k in loc}
    x = ctx.t("x").requires_grad_(bool(grads))

    def run(p):
        if mode == "a2a":
            return moe.moe_ffn_a2a(p, x, c, mesh, wire_int8=wire_int8)
        return moe.moe_ffn(p, x, c, mesh=mesh)

    if steps:
        y = ctx.t("y")
        losses = []
        for _ in range(steps):
            out, aux = run(loc if store == "dtensor" else params)
            loss = ((out - y) ** 2).mean() + aux
            g = torch.autograd.grad(loss, list(loc.values()))
            with torch.no_grad():
                for v, gg in zip(loc.values(), g):
                    v -= lr * gg
            losses.append(float(loss))
        gate = loc["gate"].detach()
        probs = torch.softmax(x @ gate, -1)
        frac = torch.nn.functional.one_hot(probs.argmax(-1),
                                           c.num_experts).float().mean(0)
        return {"losses": losses, "frac": _np(frac)}
    with spmd.record_collectives() as rec:
        out, aux = run(params)
    res = {"out": _np(out), "aux": float(aux),
           "wire": sorted({(r["kind"], r["tag"]) for r in rec}),
           "wire_bytes": [(r["kind"], r["tag"], r["bytes"]) for r in rec]}
    if grads:
        y = ctx.t("y")
        loss = ((out - y) ** 2).mean() + aux
        g = torch.autograd.grad(loss, list(loc.values()) + [x])
        res["grads"] = {k: _np(gg) for k, gg in zip(list(loc) + ["x"], g)}
    return res


def case_moe_error(ctx, cfg, n):
    from paddle_tpu_torch.parallel import moe
    c = moe.MoEConfig(**cfg)
    mesh = _mesh((4,), ("expert",))
    p = {k: ctx.t(k) for k in ("gate", "w_in", "w_out")}
    try:
        moe.moe_ffn_a2a(p, torch.zeros(n, c.d_model), c, mesh)
    except ValueError as e:
        return str(e)
    return None


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pair_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = _stage({"w": p["w"][i], "b": p["b"][i]}, x)
    return x


def case_pipe(ctx, S, M, v=1, mode="gpipe", mesh_shape=None,
              mesh_axes=("stage",), grads=False, wire_int8=False, steps=0,
              lr=0.2):
    """A pipeline over the ``stage`` axis from the JAX parameters
    (inputs ``w`` [L, D, D], ``b`` [L, D], ``x``; ``y`` for the loss)."""
    from paddle_tpu_torch.parallel import pipeline
    mesh = _mesh(mesh_shape or (S,), mesh_axes)
    w = ctx.t("w").requires_grad_(bool(grads or steps))
    b = ctx.t("b").requires_grad_(bool(grads or steps))
    x = ctx.t("x")
    L = w.shape[0]

    def run(w_, b_):
        if mode == "gpipe":
            return pipeline.pipeline_apply({"w": w_, "b": b_}, x, _stage,
                                           mesh, M, wire_int8=wire_int8)
        if mode == "blocked":        # consecutive layer blocks per stage
            p = {"w": w_.reshape((S, L // S) + tuple(w_.shape[1:])),
                 "b": b_.reshape((S, L // S) + tuple(b_.shape[1:]))}
            return pipeline.pipeline_apply(p, x, _pair_stage, mesh, M)
        p = {"w": w_.reshape((v, S) + tuple(w_.shape[1:])),
             "b": b_.reshape((v, S) + tuple(b_.shape[1:]))}
        return pipeline.pipeline_apply_interleaved(
            p, x, _stage, mesh, M, num_chunks=v, wire_int8=wire_int8)

    if steps:
        y = ctx.t("y")
        losses = []
        for _ in range(steps):
            loss = ((run(w, b) - y) ** 2).mean()
            gw, gb = torch.autograd.grad(loss, [w, b])
            with torch.no_grad():
                w -= lr * gw
                b -= lr * gb
            losses.append(float(loss))
        return {"losses": losses}
    try:
        out = run(w, b)
    except ValueError as e:
        return {"error": str(e)}
    res = {"out": _np(out)}
    if grads:
        y = ctx.t("y")
        loss = ((out - y) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, [w, b])
        res.update(loss=float(loss), gw=_np(gw), gb=_np(gb))
    return res


# ---------------------------------------------------------------------------
# the transformer's mesh paths (tests/test_torch_mesh_paths.py)
# ---------------------------------------------------------------------------

def _np_nested(ctx, prefix="p/"):
    """The inputs under ``prefix`` as a nested tree ("blocks/qkv/q8" ->
    tree["blocks"]["qkv"]["q8"]): an int8 tree keeps its nodes."""
    tree: dict = {}
    for name, arr in ctx.inputs.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


def case_mesh_loss(ctx, cfg, mesh_shape, mesh_axes, use_lengths=False,
                   seed=None):
    """``lm_loss`` under the mesh from the JAX parameters with the synced
    gradient slices, with dropout drawn from a generator seeded ``seed``
    on every rank (none when ``seed`` is None); with a seed, also the
    port's unsharded loss and gradients from the same seed."""
    import paddle_tpu_torch.models.transformer as tt
    c = _lm_cfg(cfg)
    mesh = _mesh(mesh_shape, mesh_axes)
    full = tt.train_params_from_numpy(_np_tree(ctx), device="cpu")
    loc = tt.shard_params(full, c, mesh, trainable=True)
    toks, tgt = ctx.t("toks"), ctx.t("tgt")
    lens = ctx.t("lens") if use_lengths else None

    def gen():
        return None if seed is None else torch.Generator().manual_seed(seed)

    try:
        loss = tt.lm_loss(loc, toks, tgt, c, mesh=mesh, lengths=lens,
                          generator=gen())
    except ValueError as e:
        return {"error": str(e)}
    out = {"loss": float(loss), "grads": _synced_grads(loss, loc, c, mesh)}
    if seed is not None:
        ref = tt.lm_loss(full, toks, tgt, c, lengths=lens, generator=gen())
        g = torch.autograd.grad(ref, [v for _, v in _leaves(full)])
        out["ref_loss"] = float(ref)
        out["ref_grads"] = {n: _np(gg) for (n, _), gg
                            in zip(_leaves(full), g)}
    return out


def _serving_tree(ctx, c, mesh, store):
    """The serving dict from the JAX tree in a stored layout: "shard"
    (this rank's plain shards), "dtensor", "whole" (the mesh forward
    slices it) or "int8" (the JAX int8 tree, whole)."""
    import paddle_tpu_torch.models.transformer as tt
    from paddle_tpu_torch.parallel import spmd
    full = tt.params_from_numpy(_np_nested(ctx), c, device="cpu")
    if store in ("whole", "int8"):
        return full
    loc = tt.shard_params(full, c, mesh)
    if store == "shard":
        return loc
    lays, gsh = tt.param_shardings(c, mesh), tt._global_shapes(c)

    def dt(t, lay, shape):
        return t if lay.is_fully_replicated else \
            spmd.as_dtensor(t, lay, shape)

    out = {k: dt(loc[k], lays[k], gsh[k]) for k in loc if k != "blocks"}
    out["blocks"] = {k: dt(v, lays["blocks"][k], gsh["blocks"][k])
                     for k, v in loc["blocks"].items()}
    return out


def case_mesh_serve(ctx, cfg, mesh_shape, mesh_axes, what, store="shard",
                    cache_len=24, length=None, slot=None, max_new=4,
                    temperature=0.0, key=None, beam=4):
    """One serving entry point with ``mesh=`` on every rank, the tree in
    the ``store`` layout (:func:`_serving_tree`): "prefill", "slot"
    (into row ``slot`` of the arena input ``k`` / ``v``), "generate",
    "beam" or "forward"; with the collective record of the call."""
    import paddle_tpu_torch.models.transformer as tt
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.parallel import spmd
    c = _lm_cfg(cfg)
    mesh = _mesh(mesh_shape, mesh_axes)
    params = _serving_tree(ctx, c, mesh, store)
    toks = ctx.t("toks")
    try:
        with torch.no_grad(), spmd.record_collectives() as rec:
            if what == "prefill":
                logits, cache = tt.prefill(params, toks, c, cache_len,
                                           mesh=mesh)
                res = {"logits": _np(logits), "k": _np(cache["k"]),
                       "v": _np(cache["v"])}
            elif what == "slot":
                cache = {n: ctx.t(n) for n in ("k", "v")}
                logits, cache = tt.prefill_into_slot(
                    params, cache, toks, length, slot, c, mesh=mesh)
                res = {"logits": _np(logits), "k": _np(cache["k"]),
                       "v": _np(cache["v"])}
            elif what == "generate":
                kw = {} if key is None else {"key": prng.prng_key(key)}
                ids = tt.generate(params, toks, c, max_new=max_new,
                                  temperature=temperature, mesh=mesh, **kw)
                res = {"ids": _np(ids)}
            elif what == "beam":
                seq, scores = tt.beam_search(params, toks, c,
                                             max_new=max_new,
                                             beam_size=beam, mesh=mesh)
                res = {"ids": _np(seq), "scores": _np(scores)}
            else:
                res = {"logits": _np(tt.forward(params, toks, c,
                                                mesh=mesh))}
    except ValueError as e:
        return {"error": str(e)}
    res["collectives"] = [(r["kind"], r["axis"], r["tag"]) for r in rec]
    return res
