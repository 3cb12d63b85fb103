"""Dynamic RNN DSL: recurrent_group / memory / beam_search (counterpart
of ``paddle_tpu/recurrent.py``).

The RecurrentGradientMachine equivalent. Reference:
- recurrent_group + memory + beam_search config DSL:
  python/paddle/trainer_config_helpers/layers.py
- engine: paddle/gserver/gradientmachines/RecurrentGradientMachine.h:32
  (per-step layer-subgraph execution with memory links, generation +
  beamSearch at .h:307-309), operators/recurrent_op.cc (StepScopes).

The step function defines a layer *sub-graph* once. ``recurrent_group``
runs it once per timestep in a Python loop (the JAX package's
``lax.scan``): memories are carried tensors, and a row past its length
keeps its memory. Generation runs the sub-graph under the port's
fixed-width ``ops/beam.beam_search``.
"""

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from paddle_tpu_torch import record
from paddle_tpu_torch.core.param import ParamAttr, ParamSpec
from paddle_tpu_torch.ops import beam as ops_beam
from paddle_tpu_torch.ops import sequence as ops_seq
from paddle_tpu_torch.topology import LayerOutput, Value, auto_name, topo_order
from paddle_tpu_torch.utils import enforce

_build_ctx = threading.local()


@dataclasses.dataclass
class _Memory:
    node: LayerOutput            # placeholder node used inside the step graph
    link_name: str               # layer whose output feeds the next step
    size: int
    boot: Optional[LayerOutput]  # evaluated outside the group
    boot_const: Optional[float]


class StaticInput:
    """Non-sequence input broadcast to every step (reference: StaticInput,
    trainer_config_helpers/layers.py)."""

    def __init__(self, input: LayerOutput, is_seq: bool = False):
        self.input = input
        self.is_seq = is_seq  # a whole sequence visible at every step


class GeneratedInput:
    """Generation-mode input: at each step, the embedding of the previously
    generated token (reference: GeneratedInput — embedding_name/size)."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size              # vocab size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


def _placeholder(name: str, size: int) -> LayerOutput:
    return LayerOutput(name, "step_input", [], fn=None, size=size,
                       is_data=True)


def memory(name: str, size: int, boot_layer: Optional[LayerOutput] = None,
           boot_with_const_value: Optional[float] = None,
           is_seq: bool = False) -> LayerOutput:
    """Inside a step function: the value of layer ``name`` at the previous
    step (boot value at t=0). Reference: memory() in
    trainer_config_helpers/layers.py; RecurrentGradientMachine memory links.
    """
    ctx = getattr(_build_ctx, "group", None)
    enforce.enforce(ctx is not None,
                    "memory() must be called inside a recurrent_group/"
                    "beam_search step function")
    node = _placeholder(auto_name(f"memory_{name}"), size)
    ctx.append(_Memory(node, name, size, boot_layer, boot_with_const_value))
    try:
        record.record_call(
            "paddle_tpu.recurrent.memory",
            {k: record.encode_value(v) for k, v in (
                ("name", name), ("size", size), ("boot_layer", boot_layer),
                ("boot_with_const_value", boot_with_const_value),
                ("is_seq", is_seq))}, [node])
    except record.Unserializable:
        pass
    return node


def _record_group(api: str, lo: LayerOutput, step_rec, kwargs: dict):
    """Record a recurrent_group / beam_search call whose step sub-graph
    was recorded (``record.step_record``)."""
    if step_rec is None:
        return
    try:
        enc = {k: record.encode_value(v) for k, v in kwargs.items()}
    except record.Unserializable:
        return
    record.record_call(f"paddle_tpu.recurrent.{api}",
                       {"step": {"$step": step_rec}, **enc}, [lo])


def _build_step_graph(step: Callable, placeholders: Sequence[LayerOutput]):
    """Run the user step fn collecting memories; returns (outputs, memories,
    step_layers in topo order)."""
    import paddle_tpu_torch.topology as topo_mod
    prev_group = getattr(_build_ctx, "group", None)
    _build_ctx.group = []
    created: List[LayerOutput] = []
    prev_hook = topo_mod.set_layer_creation_hook(created.append)
    try:
        outs = step(*placeholders)
    finally:
        topo_mod.set_layer_creation_hook(prev_hook)
        memories: List[_Memory] = _build_ctx.group
        _build_ctx.group = prev_group
    outs = [outs] if isinstance(outs, LayerOutput) else list(outs)
    # roots: step outputs + memory-linked layers (a carried state like an
    # LSTM cell may not be an ancestor of the emitted output)
    link_names = {m.link_name for m in memories}
    roots = list(outs) + [l for l in created if l.name in link_names]
    layers = topo_order(roots)
    by_name = {l.name: l for l in layers}
    for m in memories:
        enforce.enforce(m.link_name in by_name,
                        f"memory links to layer '{m.link_name}' which is not "
                        f"produced by the step function")
    return outs, memories, layers


def _run_step_layers(layers, params, feed_values: Dict[str, Value], ctx):
    """Execute the step sub-graph once given placeholder feed values."""
    values = dict(feed_values)
    for layer in layers:
        if layer.name in values:
            continue
        if layer.is_data:
            raise enforce.EnforceError(
                f"step sub-graph data layer '{layer.name}' was not fed — "
                f"pass it through recurrent_group(input=...) instead of "
                f"closing over it")
        parent_vals = [values[p.name] for p in layer.parents]
        values[layer.name] = layer.fn(params, parent_vals, ctx)
    return values


def _collect_params(layers) -> List[ParamSpec]:
    out, seen = [], set()
    for l in layers:
        for s in l.param_specs:
            if s.name not in seen:
                seen.add(s.name)
                out.append(s)
    return out


def recurrent_group(step: Callable, input, reverse: bool = False,
                    name: Optional[str] = None) -> LayerOutput:
    """Run a step sub-graph over a sequence with memory links.

    ``input``: sequence layer(s) and/or StaticInput wrappers. The step
    function receives one placeholder per input (the t-th token of sequence
    inputs; the whole value of static inputs) and may call ``memory()``.
    Returns the sequence of (first) step outputs.
    """
    name = name or auto_name("recurrent_group")
    raw_inputs = input if isinstance(input, (list, tuple)) else [input]
    seq_inputs: List[LayerOutput] = []
    static_inputs: List[StaticInput] = []
    placeholders = []
    for i, ri in enumerate(raw_inputs):
        if isinstance(ri, StaticInput):
            static_inputs.append(ri)
            placeholders.append(_placeholder(f"{name}@static{i}", ri.input.size))
        else:
            seq_inputs.append(ri)
            placeholders.append(_placeholder(f"{name}@in{i}", ri.size))
    enforce.enforce(seq_inputs, "recurrent_group needs >=1 sequence input")

    outs, memories, step_layers = _build_step_graph(step, placeholders)
    out0 = outs[0]
    specs = _collect_params(step_layers)
    boot_parents = [m.boot for m in memories if m.boot is not None]
    parents = seq_inputs + [s.input for s in static_inputs] + boot_parents

    seq_ph = [p for p, ri in zip(placeholders, raw_inputs)
              if not isinstance(ri, StaticInput)]
    static_ph = [p for p, ri in zip(placeholders, raw_inputs)
                 if isinstance(ri, StaticInput)]

    def fwd(params, parent_vals, ctx):
        n_seq = len(seq_inputs)
        n_static = len(static_inputs)
        seq_vals = parent_vals[:n_seq]
        static_vals = parent_vals[n_seq:n_seq + n_static]
        boot_vals = parent_vals[n_seq + n_static:]
        lengths = seq_vals[0].lengths
        enforce.enforce(lengths is not None,
                        "recurrent_group input must be a sequence")
        B, T = seq_vals[0].array.shape[:2]

        xs = [sv.array if not reverse
              else ops_seq.seq_reverse(sv.array, lengths)
              for sv in seq_vals]

        boot_iter = iter(boot_vals)
        mems = []
        for m in memories:
            if m.boot is not None:
                mems.append(next(boot_iter).array)
            else:
                fill = m.boot_const or 0.0
                dt = (xs[0].dtype if xs[0].is_floating_point()
                      else torch.float32)
                mems.append(torch.full((B, m.size), fill, dtype=dt,
                                       device=xs[0].device))
            enforce.enforce(mems[-1].shape[-1] == m.size,
                            f"memory '{m.link_name}' boot size mismatch")

        ys = []
        for t in range(T):
            feeds = {ph.name: Value(x[:, t]) for ph, x in zip(seq_ph, xs)}
            for ph, sv in zip(static_ph, static_vals):
                feeds[ph.name] = sv
            for m, mv in zip(memories, mems):
                feeds[m.node.name] = Value(mv)
            values = _run_step_layers(step_layers, params, feeds, ctx)
            alive = (t < lengths)[:, None]
            mems = [torch.where(alive, values[m.link_name].array, mv)
                    for m, mv in zip(memories, mems)]
            ys.append(values[out0.name].array)
        y = torch.stack(ys, dim=1)              # [B, T, F]
        if reverse:
            y = ops_seq.seq_reverse(y, lengths)
        return Value(y, lengths)

    lo = LayerOutput(name, "recurrent_group", parents, fwd, specs,
                     size=out0.size, activation=out0.activation)
    _record_group("recurrent_group", lo, record.step_record(
        placeholders, memories, step_layers, outs),
        {"input": input, "reverse": reverse, "name": name})
    return lo


def beam_search(step: Callable, input, bos_id: int, eos_id: int,
                beam_size: int = 5, max_length: int = 100,
                name: Optional[str] = None,
                length_penalty: float = 0.0) -> LayerOutput:
    """Generation with fixed-width beam search.

    ``input``: exactly one GeneratedInput plus any StaticInput wrappers.
    The step function receives (per GeneratedInput) the embedding of the
    previous token and must return a softmax (or logit) layer over the
    vocabulary. Output Value: tokens [batch, beam, max_length] with
    per-beam lengths in ``sub_lengths`` and scores stored in ``weights``.
    Reference: beam_search DSL (trainer_config_helpers/layers.py),
    RecurrentGradientMachine::beamSearch, beam_search_op.cc. The search's
    stop test reads one flag from the device per step, so a forward that
    holds this layer cannot be captured into a CUDA graph.
    """
    name = name or auto_name("beam_search")
    raw_inputs = input if isinstance(input, (list, tuple)) else [input]
    gen: Optional[GeneratedInput] = None
    static_inputs: List[StaticInput] = []
    placeholders = []
    for i, ri in enumerate(raw_inputs):
        if isinstance(ri, GeneratedInput):
            enforce.enforce(gen is None, "only one GeneratedInput allowed")
            gen = ri
            placeholders.append(_placeholder(f"{name}@gen", ri.embedding_size))
        elif isinstance(ri, StaticInput):
            static_inputs.append(ri)
            placeholders.append(_placeholder(f"{name}@static{i}", ri.input.size))
        else:
            raise enforce.EnforceError(
                "beam_search inputs must be GeneratedInput/StaticInput")
    enforce.enforce(gen is not None, "beam_search needs a GeneratedInput")

    outs, memories, step_layers = _build_step_graph(step, placeholders)
    out0 = outs[0]
    enforce.enforce(out0.size == gen.size,
                    f"step output size {out0.size} != vocab {gen.size}")
    specs = _collect_params(step_layers)
    emb_spec = ParamSpec(gen.embedding_name, (gen.size, gen.embedding_size),
                         attr=ParamAttr(name=gen.embedding_name),
                         fan_in=gen.embedding_size)
    if gen.embedding_name not in {s.name for s in specs}:
        specs = specs + [emb_spec]
    boot_parents = [m.boot for m in memories if m.boot is not None]
    parents = [s.input for s in static_inputs] + boot_parents

    gen_ph = placeholders[[isinstance(r, GeneratedInput)
                           for r in raw_inputs].index(True)]
    static_ph = [p for p, ri in zip(placeholders, raw_inputs)
                 if isinstance(ri, StaticInput)]
    V, K = gen.size, beam_size

    def fwd(params, parent_vals, ctx):
        n_static = len(static_inputs)
        static_vals = parent_vals[:n_static]
        boot_vals = parent_vals[n_static:]
        first = static_vals[0].array if static_vals else boot_vals[0].array
        B, device = first.shape[0], first.device

        def tile_beam(x):
            return x[:, None].expand((B, K) + tuple(x.shape[1:]))

        boot_iter = iter(boot_vals)
        mem0 = {}
        for m in memories:
            if m.boot is not None:
                mem0[m.link_name] = tile_beam(next(boot_iter).array)
            else:
                mem0[m.link_name] = torch.full((B, K, m.size),
                                               m.boot_const or 0.0,
                                               dtype=torch.float32,
                                               device=device)
        # the static inputs tiled over the beam once, not per step
        static_feeds = {}
        for ph, sv in zip(static_ph, static_vals):
            arr = sv.array
            flat = tile_beam(arr).reshape((B * K,) + tuple(arr.shape[1:]))
            lens = (torch.repeat_interleave(sv.lengths, K)
                    if sv.is_sequence else None)
            static_feeds[ph.name] = Value(flat, lens)

        def step_fn(last_tok, mems):
            flat_tok = last_tok.reshape(B * K).long()
            emb = params[gen.embedding_name][flat_tok]
            feeds = {gen_ph.name: Value(emb), **static_feeds}
            for m in memories:
                feeds[m.node.name] = Value(
                    mems[m.link_name].reshape((B * K, -1)))
            values = _run_step_layers(step_layers, params, feeds, ctx)
            ov = values[out0.name]
            if ov.pre_act is not None:
                logp = torch.log_softmax(ov.pre_act.float(), dim=-1)
            elif out0.activation == "softmax":
                logp = torch.log(torch.clamp_min(ov.array.float(), 1e-30))
            else:
                logp = torch.log_softmax(ov.array.float(), dim=-1)
            new_mems = {m.link_name:
                        values[m.link_name].array.reshape(B, K, -1)
                        for m in memories}
            return logp.reshape(B, K, V), new_mems

        tokens, lengths, scores = ops_beam.beam_search(
            step_fn, mem0, B, K, V, bos_id, eos_id, max_length,
            length_penalty=length_penalty)
        return Value(tokens, lengths=None, sub_lengths=lengths,
                     weights=scores)

    lo = LayerOutput(name, "beam_search", parents, fwd, specs,
                     size=max_length)
    _record_group("beam_search", lo, record.step_record(
        placeholders, memories, step_layers, outs),
        {"input": input, "bos_id": bos_id, "eos_id": eos_id,
         "beam_size": beam_size, "max_length": max_length, "name": name,
         "length_penalty": length_penalty})
    return lo
