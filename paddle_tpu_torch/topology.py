"""Layer graph → one plain forward function (counterpart of
``paddle_tpu/topology.py``).

The reference compiled a declarative layer config into a protobuf
(python/paddle/trainer/config_parser.py → ModelConfig,
python/paddle/v2/topology.py:27) executed layer by layer by a C++
GradientMachine (gserver/gradientmachines/NeuralNetwork.cpp:245,295). The
JAX package compiles the graph into one pure function that ``jax.jit``
traces; the port keeps the same function over dicts of tensors and runs
it eagerly: gradients come from ``torch.autograd`` over a parameter dict
of leaf tensors, running statistics come back in ``new_state`` as new
tensors (never updated in place).

Runtime values flow as ``Value`` — a tensor plus optional sequence
metadata — mirroring the reference's ``Argument`` (value +
sequenceStartPositions, paddle/parameter/Argument.h:26,84).
"""

import dataclasses
import itertools
import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.param import ParamSpec
from paddle_tpu_torch.ops import prng
from paddle_tpu_torch.utils import enforce


@dataclasses.dataclass
class Value:
    """Runtime value of a layer: a tensor + optional sequence metadata
    (the Argument equivalent). For sparse inputs (sparse_binary_vector /
    sparse_float_vector), ``array`` holds padded nonzero indices [b, k] and
    ``weights`` the matching values (0-weight entries are padding)."""
    array: torch.Tensor
    lengths: Optional[torch.Tensor] = None       # [batch] for sequence data
    sub_lengths: Optional[torch.Tensor] = None   # level-2 LoD
    weights: Optional[torch.Tensor] = None       # sparse nonzero values
    pre_act: Optional[torch.Tensor] = None       # logits before the activation
    aux: Optional[dict] = None                   # recipe side-channel (the
                                                 # q8 stash + batch stats)

    @property
    def is_sequence(self):
        return self.lengths is not None

    @property
    def is_sparse(self):
        return self.weights is not None

    def with_array(self, array, pre_act=None) -> "Value":
        # aux is deliberately NOT carried: it describes the q8 stash of
        # THIS array; any transformed array no longer matches the stash
        return Value(array, self.lengths, self.sub_lengths, self.weights,
                     pre_act)

    def to(self, device) -> "Value":
        """The same value with every tensor on ``device``."""
        def mv(t):
            return t.to(device) if isinstance(t, torch.Tensor) else t
        aux = None if self.aux is None else {k: mv(v)
                                             for k, v in self.aux.items()}
        return Value(mv(self.array), mv(self.lengths), mv(self.sub_lengths),
                     mv(self.weights), mv(self.pre_act), aux)


def as_value(v, device=None) -> Value:
    """``v`` as a Value: a Value passes through, a tensor or an array
    (numpy's int64/float64 narrowed to int32/float32, as ``jnp.asarray``
    without x64) becomes one, on ``device`` when given."""
    if isinstance(v, Value):
        return v if device is None else v.to(device)
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        v = torch.from_numpy(np.ascontiguousarray(a))
    return Value(v if device is None else v.to(device))


@dataclasses.dataclass
class ForwardContext:
    """Per-invocation context threaded to every layer forward."""
    is_training: bool = False
    dropout_key: Optional[torch.Tensor] = None   # folded per layer name
    state_in: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    state_out: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def layer_key(self, name: str) -> Optional[torch.Tensor]:
        """``fold_in(dropout_key, crc32(name))``: the JAX package's key for
        the same layer and step."""
        if self.dropout_key is None:
            return None
        return prng.fold_in(self.dropout_key,
                            zlib.crc32(name.encode()) & 0x7FFFFFFF)


# recurrent-group builds install a (thread-local) hook to capture every
# LayerOutput created while building a step function (memory links resolve
# by name even when the linked layer is not an ancestor of the step outputs)
_hook_local = threading.local()


def set_layer_creation_hook(fn):
    prev = getattr(_hook_local, "fn", None)
    _hook_local.fn = fn
    return prev


_name_lock = threading.Lock()
_name_counters: Dict[str, "itertools.count"] = {}


def auto_name(layer_type: str) -> str:
    """Unique default layer names (reference: config_parser.py assigned
    __fc_layer_0__ style names). The counters are this package's, per
    process: graphs compared across packages name their layers."""
    with _name_lock:
        c = _name_counters.setdefault(layer_type, itertools.count())
        return f"__{layer_type}_{next(c)}__"


class LayerOutput:
    """A node in the layer graph (reference: v2 layer.py LayerOutput /
    config_parser LayerConfig). Holds parents, parameter specs, and a forward
    callable ``fn(params, parent_values, ctx) -> Value``."""

    def __init__(self, name: str, layer_type: str, parents: Sequence["LayerOutput"],
                 fn: Callable, param_specs: Sequence[ParamSpec] = (),
                 size: Optional[int] = None, activation: Optional[str] = None,
                 state_specs: Sequence[ParamSpec] = (), is_data: bool = False,
                 data_spec=None):
        self.name = name
        self.layer_type = layer_type
        self.parents = list(parents)
        self.fn = fn
        self.param_specs = list(param_specs)
        self.state_specs = list(state_specs)   # non-trainable (BN stats)
        self.size = size
        self.activation = activation
        self.is_data = is_data
        self.data_spec = data_spec
        # creation record (api + encoded kwargs) attached by the recorder
        # installed over the public layer API (record.py) — the program
        # save format's rebuild handle
        self.config = None
        hook = getattr(_hook_local, "fn", None)
        if hook is not None:
            hook(self)

    def __repr__(self):
        return f"<{self.layer_type} {self.name} size={self.size}>"


def topo_order(outputs: Sequence[LayerOutput]) -> List[LayerOutput]:
    """Deterministic post-order DFS over the layer DAG."""
    seen, order = set(), []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for p in node.parents:
            visit(p)
        order.append(node)

    for o in outputs:
        visit(o)
    return order


class Topology:
    """The compiled-model handle (reference: python/paddle/v2/topology.py:27 —
    Topology(cost) extracted the ModelConfig proto; here it extracts param
    specs and builds the forward)."""

    def __init__(self, outputs):
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: List[LayerOutput] = list(outputs)
        self.layers = topo_order(self.outputs)
        names = [l.name for l in self.layers]
        enforce.enforce(len(names) == len(set(names)),
                        "duplicate layer names: %s" % names)
        self.data_layers = [l for l in self.layers if l.is_data]
        # q8 producers defer their BN affine + activation to the consumer;
        # a q8-unaware consumer would silently train on the raw pre-BN
        # carrier while eval applies the full BN+act — catch at build time
        _q8_aware = {"img_conv_bn_q8", "addto_q8", "q8_exit"}
        for l in self.layers:
            if getattr(l, "_q8", None) is None:
                continue
            for o in self.outputs:
                enforce.enforce(
                    o is not l,
                    f"q8 layer {l.name!r} cannot be a graph output — its "
                    f"BN/activation are deferred; insert layer.q8_exit")
        for l in self.layers:
            for p in l.parents:
                enforce.enforce(
                    getattr(p, "_q8", None) is None
                    or l.layer_type in _q8_aware,
                    f"layer {l.name!r} ({l.layer_type}) consumes q8 "
                    f"producer {p.name!r} but is not q8-aware — insert "
                    f"layer.q8_exit between them")

    # -- specs -------------------------------------------------------------
    def param_specs(self) -> List[ParamSpec]:
        out, seen = [], set()
        for l in self.layers:
            for s in l.param_specs:
                if s.name not in seen:
                    seen.add(s.name)
                    out.append(s)
        return out

    def state_specs(self) -> List[ParamSpec]:
        out, seen = [], set()
        for l in self.layers:
            for s in l.state_specs:
                if s.name not in seen:
                    seen.add(s.name)
                    out.append(s)
        return out

    def data_names(self) -> List[str]:
        return [l.name for l in self.data_layers]

    def find(self, name: str) -> LayerOutput:
        """Address any layer's output by name (the get_output capability:
        reference gserver GetOutputLayer)."""
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(f"no layer named {name!r}; have "
                       f"{[l.name for l in self.layers]}")

    # -- compile -----------------------------------------------------------
    def compile(self, extra_outputs: Sequence[LayerOutput] = ()):
        """Build forward(params, state, feeds, *, is_training, dropout_key)
        -> (outputs: dict name->Value, new_state: dict).

        feeds: dict data-layer-name -> Value (or tensor / array).
        ``dropout_key``: an ``ops/prng`` key (int64 [2] words). The
        returned callable is a plain function of its arguments."""
        wanted = list(self.outputs) + list(extra_outputs)
        layers = topo_order(wanted)

        def forward(params: Dict, state: Dict, feeds: Dict, *,
                    is_training: bool = False, dropout_key=None):
            ctx = ForwardContext(is_training=is_training,
                                 dropout_key=dropout_key, state_in=dict(state))
            values: Dict[str, Value] = {}
            for layer in layers:
                with enforce.layer_scope(layer.name):
                    if layer.is_data:
                        values[layer.name] = as_value(feeds[layer.name])
                    else:
                        parent_vals = [values[p.name] for p in layer.parents]
                        values[layer.name] = layer.fn(params, parent_vals, ctx)
            # strip pre_act from returned outputs: the logits kept for cost
            # fusion are dead weight once a softmax layer is itself an output
            outs = {o.name: values[o.name].with_array(values[o.name].array)
                    for o in wanted}
            return outs, ctx.state_out

        return forward

    # -- serialization (program save format) --------------------------------
    def to_dict(self):
        """Structural + rebuildable description for merged-model artifacts
        (replaces the ModelConfig proto, proto/ModelConfig.proto:652). Each
        layer carries its creation record (api + encoded kwargs) when the
        public API recorded one; ``from_dict`` replays those records. The
        format is the JAX package's: either package replays the other's."""
        return {
            "format_version": 1,
            "outputs": [o.name for o in self.outputs],
            "layers": [
                {
                    "name": l.name, "type": l.layer_type, "size": l.size,
                    "parents": [p.name for p in l.parents],
                    "params": [s.name for s in l.param_specs],
                    "activation": l.activation,
                    "config": l.config,
                } for l in self.layers
            ],
        }

    def is_rebuildable(self):
        """True if every non-data layer carries a creation record."""
        return all(l.config is not None for l in self.layers)

    @classmethod
    def from_dict(cls, d) -> "Topology":
        """Rebuild the layer graph by replaying recorded API calls — the
        merged-model loader's half of the program save format (reference
        slot: config_parser.parse_config re-creating a GradientMachine
        from a saved ModelConfig, paddle/capi/gradient_machine.h:52)."""
        from paddle_tpu_torch import record

        nodes = record.replay(d["layers"], {})
        return cls([nodes[n] for n in d["outputs"]])
