"""Merged-model serving artifacts — one file holding topology + weights
(counterpart of ``paddle_tpu/io/merged.py``, the same tar format).

Reference: paddle/trainer/MergeModel.cpp packed the ModelConfig proto and
the parameter files into a single binary consumed by the C inference API
(paddle/capi/gradient_machine.h:36-88, create_for_inference_with_parameters).

The tar's members and ``meta.json`` keys are the JAX package's:
``topology.json`` (``Topology.to_dict``'s replayable layer-call records,
package-neutral API paths), ``params.npz`` (int8 codes and scales under
``@q8`` / ``@q8scale`` suffixed keys when ``weights_int8``: format 2, else
1), ``state.npz`` and ``meta.json``. An artifact written by either package
replays in the other. The JAX package may also hold compiled modules
(``exported_bs*.bin``, StableHLO): the loader here skips them. The port
writes none; ``export_batch_sizes`` is stamped in ``meta.json``, and
``MergedModel.aot_compile(bs)`` captures the replayed forward at that
batch size as a CUDA graph (``core/graphs.StepProgram``), the port's
fixed-shape compiled module.
"""

import io as _io
import json
import tarfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import place

FORMAT_VERSION = 2   # max supported; plain artifacts still save as v1


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **{k: _np(v) for k, v in arrays.items()})
    return buf.getvalue()


def _npz_load(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(_io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _add_member(tar, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = int(time.time())
    tar.addfile(info, _io.BytesIO(data))


def _serve_fn(topology):
    """forward(params, state, feeds-of-tensors) -> {output: tensor}.
    Sequence inputs pass their lengths as a sibling '<name>.lengths' key.
    Quantized weight entries ({"q8","scale"} nodes, weights_int8
    artifacts) dequantize at entry."""
    from paddle_tpu_torch.ops import q8 as ops_q8
    from paddle_tpu_torch.topology import Value

    fwd = topology.compile()

    def serve(params, state, feeds):
        params = ops_q8.dequantize_tree(params)
        vals = {k: Value(v, lengths=feeds.get(f"{k}.lengths"))
                for k, v in feeds.items() if not k.endswith(".lengths")}
        outs, _ = fwd(params, state, vals, is_training=False)
        return {k: v.array for k, v in outs.items()}

    return serve


# npz holds a FLAT name->array dict; quantized entries ride two suffixed
# keys and are reassembled into {"q8","scale"} nodes at load
_Q8_KEY, _Q8_SCALE_KEY = "@q8", "@q8scale"


def quantize_v2_params(values, min_size: int = 4096):
    """Per-output-channel int8 for the v2 parameter dict's big matmul/conv
    weights (name '*.w', ndim >= 2, float, >= min_size elements): the
    contraction axes are everything but the trailing output-channel axis
    (fc [in, out]; conv HWIO; embeddings get per-column scales). Biases,
    BN affines, and small tensors stay fp32. The codes and scales are the
    JAX package's byte for byte (``ops/q8.quantize_weight``)."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    out = {}
    for k, v in values.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, copy=True))
        if (k.endswith(".w") and t.dim() >= 2 and t.numel() >= min_size
                and t.is_floating_point()):
            out[k] = ops_q8.quantize_weight(t.detach(),
                                            tuple(range(t.dim() - 1)))
        else:
            out[k] = v
    return out


def _split_quantized(values):
    """{name: array-or-node} -> flat npz dict with suffixed q8 keys."""
    from paddle_tpu_torch.ops import q8 as ops_q8

    flat = {}
    for k, v in values.items():
        if ops_q8.is_quantized_weight(v):
            flat[k + _Q8_KEY] = _np(v["q8"])
            flat[k + _Q8_SCALE_KEY] = _np(v["scale"])
        else:
            flat[k] = _np(v)
    return flat


def _join_quantized(flat):
    """Inverse of _split_quantized."""
    values = {}
    for k, v in flat.items():
        if k.endswith(_Q8_SCALE_KEY):
            continue
        if k.endswith(_Q8_KEY):
            name = k[: -len(_Q8_KEY)]
            values[name] = {"q8": v, "scale": flat[name + _Q8_SCALE_KEY]}
        else:
            values[k] = v
    return values


def example_feeds(topology, batch_size: int) -> Dict[str, np.ndarray]:
    """Zero-filled feed arrays matching the topology's data specs."""
    from paddle_tpu_torch.data_type import Kind, SeqLevel

    feeds = {}
    for l in topology.data_layers:
        spec = l.data_spec
        if spec is None:
            raise ValueError(f"data layer {l.name!r} has no data spec")
        if spec.kind == Kind.INDEX:
            shape = (batch_size,) if spec.seq == SeqLevel.NO_SEQUENCE \
                else (batch_size, 16)
            feeds[l.name] = np.zeros(shape, np.int32)
        else:
            shape = (batch_size, spec.dim) if spec.seq == SeqLevel.NO_SEQUENCE \
                else (batch_size, 16, spec.dim)
            feeds[l.name] = np.zeros(shape, np.float32)
        if spec.seq != SeqLevel.NO_SEQUENCE:
            feeds[f"{l.name}.lengths"] = np.full((batch_size,), 16, np.int32)
    return feeds


def save_inference_model(path: str, output_layer, parameters,
                         export_batch_sizes: Sequence[int] = (),
                         platforms: Optional[Sequence[str]] = None,
                         weights_int8: bool = False) -> None:
    """Write the one-file serving artifact.

    output_layer: LayerOutput or list; parameters: Parameters (or any
    object with .values/.state dicts). export_batch_sizes: stamped in
    ``meta.json`` as the batch sizes to capture (``aot_compile``); no
    compiled module is written, and ``platforms`` is ignored.
    weights_int8: store the big '*.w' weights per-output-channel int8
    (quantize_v2_params); the serve path dequantizes at entry. A topology
    that cannot be rebuilt from its records raises ValueError: the port
    has no compiled module to fall back on.
    """
    from paddle_tpu_torch.topology import Topology

    outputs = output_layer if isinstance(output_layer, (list, tuple)) \
        else [output_layer]
    topo = Topology(list(outputs))
    if not topo.is_rebuildable():
        raise ValueError(
            "topology has unrecordable layers (a recurrent_group or "
            "beam_search step closure, a mixed layer) — the artifact "
            "would not be servable, and the port writes no compiled "
            "module to serve it instead")

    values = parameters.values
    if weights_int8:
        values = quantize_v2_params(values)

    meta = {
        # quantized artifacts use the v2 params encoding (@q8 suffixed
        # npz keys); plain artifacts stay v1 so older loaders keep working
        "format_version": 2 if weights_int8 else 1,
        "weights_int8": weights_int8,
        "outputs": [o.name for o in topo.outputs],
        "data_layers": topo.data_names(),
        "data_specs": {l.name: [l.data_spec.dim, l.data_spec.kind.value,
                                l.data_spec.seq.value]
                       for l in topo.data_layers if l.data_spec is not None},
        "rebuildable": True,
        "export_batch_sizes": [int(b) for b in export_batch_sizes],
        "cost_analysis": {},
    }

    with tarfile.open(path, "w") as tar:
        _add_member(tar, "topology.json",
                    json.dumps(topo.to_dict()).encode())
        _add_member(tar, "params.npz",
                    _npz_bytes(_split_quantized(values)))
        _add_member(tar, "state.npz", _npz_bytes(parameters.state))
        _add_member(tar, "meta.json", json.dumps(meta).encode())


class MergedModel:
    """Loaded serving artifact (the create_for_inference_with_parameters
    equivalent) on one device. ``infer`` runs the replayed topology
    eagerly (any batch size); ``call_exported`` replays the CUDA graph
    ``aot_compile`` captured at a fixed batch size (on the CPU it runs
    the same function)."""

    def __init__(self, meta, topology, params, state, device=None):
        self.meta = meta
        self.topology = topology
        self.device = place.resolve_device(device)
        to = lambda a: torch.from_numpy(np.array(a, copy=True)).to(self.device)
        self.params = {k: ({n: to(x) for n, x in v.items()}
                           if isinstance(v, dict) else to(v))
                       for k, v in params.items()}
        self.state = {k: to(v) for k, v in state.items()}
        self._serve = None
        self._programs = {}                # {batch_size: compiled forward}

    @property
    def outputs(self):
        return self.meta["outputs"]

    @property
    def cost_analysis(self):
        """{batch_size: {"flops", "bytes_accessed"}} stamped at export
        time (empty: the port stamps none)."""
        return {int(k): v for k, v in
                self.meta.get("cost_analysis", {}).items()}

    def _forward(self):
        if self._serve is None:
            if self.topology is None:
                raise ValueError("artifact has no replayable topology")
            self._serve = _serve_fn(self.topology)
        return self._serve

    def _feeds(self, feeds: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        from paddle_tpu_torch.topology import as_value
        return {k: as_value(v, self.device).array for k, v in feeds.items()}

    def infer(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            outs = self._forward()(self.params, self.state, self._feeds(feeds))
        return {k: _np(v.float() if v.dtype == torch.bfloat16 else v)
                for k, v in outs.items()}

    def aot_compile(self, batch_size: int):
        """Capture the forward at a fixed batch size (the shapes of
        ``example_feeds``) into a ``StepProgram``: the first call warms
        up and captures a CUDA graph, here, with zero feeds. Returns
        ``compiled(params, state, feeds) -> {output: tensor}``, the
        calling convention of the JAX package's compiled executable
        (``params`` / ``state`` must be this model's own dicts, feeds
        numpy arrays; the outputs live in the graph's memory until the
        next replay). A forward that syncs with the host
        (``beam_search``'s stop test) cannot be captured: the capture
        raises ``GraphCaptureError``."""
        from paddle_tpu_torch.core import graphs

        if self.topology is None:
            raise ValueError("no replayable topology to compile")
        serve = self._forward()
        feeds = example_feeds(self.topology, batch_size)
        keys = sorted(feeds)

        def run(params, state, *arrays):
            with torch.no_grad():
                return serve(params, state, dict(zip(keys, arrays)))

        prog = graphs.StepProgram(run, f"merged_bs{batch_size}")

        def compiled(params, state, feeds):
            return prog(params, state,
                        *[np.ascontiguousarray(_np(feeds[k])) for k in keys])

        compiled(self.params, self.state, feeds)
        compiled.program = prog
        self._programs[batch_size] = compiled
        return compiled

    def call_exported(self, feeds: Dict[str, np.ndarray],
                      batch_size: Optional[int] = None):
        """Run the forward captured at this batch size (``aot_compile``;
        a size stamped in ``meta.json``'s ``export_batch_sizes`` is
        captured at its first call)."""
        bs = batch_size or next(iter(feeds.values())).shape[0]
        if bs not in self._programs:
            if bs not in self.meta.get("export_batch_sizes", []):
                raise KeyError(f"no export for batch size {bs}; "
                               f"available: {sorted(self._programs)}")
            self.aot_compile(bs)
        outs = self._programs[bs](self.params, self.state, feeds)
        return {k: _np(v) for k, v in outs.items()}


def load_inference_model(path: str, device=None) -> MergedModel:
    """Load the artifact in a process that never built the model, on
    ``device`` (default: the card). Compiled modules a JAX-written
    artifact holds (``exported_bs*.bin``) are skipped."""
    from paddle_tpu_torch.topology import Topology

    with tarfile.open(path, "r") as tar:
        members = {m.name: tar.extractfile(m).read()
                   for m in tar.getmembers()
                   if not m.name.startswith("exported_bs")}
    meta = json.loads(members["meta.json"])
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"artifact format {meta['format_version']} is "
                         f"newer than this loader ({FORMAT_VERSION})")
    topo = None
    if "topology.json" in members:
        topo = Topology.from_dict(json.loads(members["topology.json"]))
    params = _join_quantized(_npz_load(members["params.npz"]))
    state = _npz_load(members["state.npz"])
    return MergedModel(meta, topo, params, state, device)
