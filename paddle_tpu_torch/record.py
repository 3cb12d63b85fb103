"""Layer-call recording — the program save format's front half
(counterpart of ``paddle_tpu/record.py``).

The reference persisted models as a ModelConfig protobuf next to the
weights (python/paddle/trainer/config_parser.py; trainer/MergeModel.cpp
packed both into one artifact). Here the Python call graph IS the config:
each public layer-API call (name + JSON-able kwargs) is recorded on the
LayerOutput it produces; ``Topology.to_dict`` persists those records and
``Topology.from_dict`` replays them in a process that never saw the
model-building code.

Recorded API paths are package-neutral: the port writes
``paddle_tpu.<module>.<fn>``, the path the JAX package writes, and
``resolve_api`` maps the ``paddle_tpu.`` prefix onto this package, so a
``topology.json`` written by either package replays in both.

The port also records ``recurrent_group`` and ``beam_search``, whose
step function the JAX package cannot serialize: the step's sub-graph is
recorded as its placeholders, its ``memory`` calls and the records of
the layers it built (``"$step"``), with ``StaticInput`` /
``GeneratedInput`` arguments (``"$static_input"``, ``"$generated_input"``),
and replayed into a new step function. Such a record is the port's own:
the JAX package cannot decode it, and serves those graphs through its
compiled modules instead. Calls whose arguments cannot be serialized
otherwise carry no record.
"""

import dataclasses
import functools
import inspect
import itertools
import threading

_SCALARS = (bool, int, float, str, bytes, type(None))
_call_ids = itertools.count()
_lock = threading.Lock()

_PORT, _NEUTRAL = "paddle_tpu_torch.", "paddle_tpu."


class Unserializable(Exception):
    """Argument cannot be represented in the program save format."""


def encode_value(v):
    from paddle_tpu_torch.activation import BaseActivation
    from paddle_tpu_torch.core.param import ParamAttr
    from paddle_tpu_torch.data_type import InputType
    from paddle_tpu_torch.pooling import BasePoolingType
    from paddle_tpu_torch.recurrent import GeneratedInput, StaticInput
    from paddle_tpu_torch.topology import LayerOutput

    if isinstance(v, StaticInput):
        return {"$static_input": {"input": encode_value(v.input),
                                  "is_seq": v.is_seq}}
    if isinstance(v, GeneratedInput):
        return {"$generated_input": {"size": v.size,
                                     "embedding_name": v.embedding_name,
                                     "embedding_size": v.embedding_size}}
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, LayerOutput):
        return {"$layer": v.name}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            raise Unserializable(f"non-string dict keys: {v!r}")
        return {"$dict": {k: encode_value(x) for k, x in v.items()}}
    if isinstance(v, ParamAttr):
        return {"$param_attr": dataclasses.asdict(v)}
    if isinstance(v, InputType):
        return {"$input_type": [v.dim, v.kind.value, v.seq.value]}
    if isinstance(v, BaseActivation):
        return {"$act": v.name}
    if isinstance(v, BasePoolingType) or (
            isinstance(v, type) and issubclass(v, BasePoolingType)):
        return {"$pool": v.name}
    raise Unserializable(f"{type(v).__name__}: {v!r}")


def decode_value(v, nodes):
    """Inverse of encode_value; ``nodes`` maps layer name -> LayerOutput."""
    from paddle_tpu_torch import activation as act_mod
    from paddle_tpu_torch.core.param import ParamAttr
    from paddle_tpu_torch.data_type import InputType, Kind, SeqLevel

    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, list):
        return [decode_value(x, nodes) for x in v]
    if isinstance(v, dict):
        if "$layer" in v:
            return nodes[v["$layer"]]
        if "$dict" in v:
            return {k: decode_value(x, nodes) for k, x in v["$dict"].items()}
        if "$param_attr" in v:
            return ParamAttr(**v["$param_attr"])
        if "$input_type" in v:
            dim, kind, seq = v["$input_type"]
            return InputType(dim, Kind(kind), SeqLevel(seq))
        if "$act" in v:
            for cls in vars(act_mod).values():
                if (isinstance(cls, type)
                        and issubclass(cls, act_mod.BaseActivation)
                        and cls.name == v["$act"]):
                    return cls()
            raise ValueError(f"unknown activation {v['$act']!r}")
        if "$pool" in v:
            return v["$pool"]   # layer APIs accept the string name
        if "$static_input" in v:
            from paddle_tpu_torch.recurrent import StaticInput
            s = v["$static_input"]
            return StaticInput(decode_value(s["input"], nodes), s["is_seq"])
        if "$generated_input" in v:
            from paddle_tpu_torch.recurrent import GeneratedInput
            return GeneratedInput(**v["$generated_input"])
        if "$step" in v:
            return _step_function(v["$step"], nodes)
    raise ValueError(f"cannot decode {v!r}")


def replay(entries, nodes, strict=True):
    """Replay layer records (``Topology.to_dict``'s ``layers`` entries, in
    order) into ``nodes`` (layer name -> LayerOutput, extended in place).
    A call with several outputs is made once. ``strict``: the rebuilt
    layer must carry the recorded name (inside a step sub-graph, a
    memory's node is auto-named and is found by its recorded name)."""
    import inspect

    from paddle_tpu_torch.topology import LayerOutput
    from paddle_tpu_torch.utils import enforce

    calls = {}
    for entry in entries:
        cfg = entry.get("config")
        if cfg is None:
            raise ValueError(
                f"layer {entry['name']!r} ({entry.get('type')}) has no "
                f"creation record — this graph cannot be rebuilt from "
                f"its dict, and the port has no compiled-module "
                f"fallback")
        cid = cfg["call"]
        if cid not in calls:
            fn = resolve_api(cfg["api"])
            kwargs = {k: decode_value(x, nodes)
                      for k, x in cfg["kwargs"].items()}
            # pin the recorded name so parameters keyed by layer name
            # resolve identically in the rebuilding process (auto_name
            # counters differ between processes)
            if ("name" in inspect.signature(fn).parameters
                    and not kwargs.get("name")
                    and len(cfg["out_names"]) == 1):
                kwargs["name"] = entry["name"]
            result = fn(**kwargs)
            outs = result if isinstance(result, (list, tuple)) else [result]
            calls[cid] = [o for o in outs if isinstance(o, LayerOutput)]
        node = calls[cid][cfg["out_index"]]
        enforce.enforce(
            not strict or node.name == entry["name"],
            "rebuilt layer name %r != recorded %r (api %s)"
            % (node.name, entry["name"], cfg["api"]))
        nodes[entry["name"]] = node
    return nodes


def step_record(placeholders, memories, layers, outs):
    """The ``"$step"`` record of a step sub-graph, or None when a layer of
    it carries no creation record."""
    mem_nodes = {id(m.node) for m in memories}
    ph = {id(p) for p in placeholders}
    body = [l for l in layers if id(l) not in ph and id(l) not in mem_nodes]
    if any(l.config is None for l in body) or any(
            m.node.config is None for m in memories):
        return None
    entry = lambda l: {"name": l.name, "config": l.config}
    return {"placeholders": [p.name for p in placeholders],
            "memories": [entry(m.node) for m in memories],
            "layers": [entry(l) for l in body],
            "outputs": [o.name for o in outs]}


def _step_function(rec, nodes):
    """A step function that rebuilds a recorded step sub-graph on the
    placeholders it is given (outer layers, such as boot layers, resolve
    from ``nodes``)."""
    def step(*placeholders):
        local = dict(nodes)
        local.update(zip(rec["placeholders"], placeholders))
        replay(rec["memories"], local, strict=False)
        replay(rec["layers"], local)
        outs = [local[n] for n in rec["outputs"]]
        return outs[0] if len(outs) == 1 else outs
    return step


def record_call(api_path, kwargs, outs):
    """Attach one call's record to its output layers (for the API calls
    the generic wrapper cannot encode: memory, recurrent_group,
    beam_search). ``kwargs`` are already encoded."""
    with _lock:
        cid = next(_call_ids)
    cfg = {"api": api_path, "kwargs": kwargs, "call": cid,
           "out_names": [o.name for o in outs]}
    for i, o in enumerate(outs):
        o.config = {**cfg, "out_index": i}


def _outputs_of(result):
    from paddle_tpu_torch.topology import LayerOutput
    if isinstance(result, LayerOutput):
        return [result]
    if isinstance(result, (list, tuple)):
        return [r for r in result if isinstance(r, LayerOutput)]
    return []


def _recorded(api_path, fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        result = fn(*args, **kwargs)
        outs = _outputs_of(result)
        if outs and all(getattr(o, "config", None) is None for o in outs):
            # inner (already-recorded) calls win: a composite that merely
            # wraps recorded layer calls needs no record of its own
            try:
                bound = sig.bind(*args, **kwargs)
                enc = {k: encode_value(v) for k, v in bound.arguments.items()}
                with _lock:
                    cid = next(_call_ids)
                cfg = {"api": api_path, "kwargs": enc, "call": cid,
                       "out_names": [o.name for o in outs]}
                for i, o in enumerate(outs):
                    o.config = {**cfg, "out_index": i}
            except Unserializable:
                pass
        return result

    return wrapped


def neutral_path(module_name: str) -> str:
    """``paddle_tpu_torch.layer`` -> ``paddle_tpu.layer``: the module
    path both packages write."""
    if module_name.startswith(_PORT):
        return _NEUTRAL + module_name[len(_PORT):]
    return module_name


def install(module, public=None):
    """Wrap a module's public layer functions with call recording."""
    names = public if public is not None else [
        n for n in vars(module)
        if not n.startswith("_") and inspect.isfunction(vars(module)[n])
        and vars(module)[n].__module__ == module.__name__]
    prefix = neutral_path(module.__name__)
    for n in names:
        setattr(module, n, _recorded(f"{prefix}.{n}", getattr(module, n)))


def resolve_api(api_path):
    """'paddle_tpu.layer.fc' (or 'paddle_tpu_torch.layer.fc') -> this
    package's (recorded) function object."""
    import importlib
    mod_name, _, attr = api_path.rpartition(".")
    if mod_name.startswith(_NEUTRAL):
        mod_name = _PORT + mod_name[len(_NEUTRAL):]
    return getattr(importlib.import_module(mod_name), attr)
