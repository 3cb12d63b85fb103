"""What every cell shares: finding a cell's files by name, the card
check, the metric readers, the profiler's reading and the result line.

A cell is ``cells/<name>.json``: the configuration it runs
(``configs/<config>.json``), the driver that runs it (``<driver>.py``
beside this file: ``serve`` or ``train``) and the driver's parameters.
A per-layer metric is ``metrics/<metric>.py`` with one function,
``read(ctx) -> float | None``, over what the driver recorded. Which
metrics a cell reports comes from ``BENCHMARK.json``. So a cell, a
configuration or a metric is added as files and entries alone.
"""

import bisect
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_tpu")
SPAN_PREFIX = "perfbench."          # the benchmark's own spans


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str, base: Path = HERE) -> dict:
    """``cells/<name>.json`` under ``base``, with its configuration file
    under ``"model"``."""
    path = base / "cells" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no cell {name!r} (no cells/{name}.json)")
    cell = load_json(path)
    cell["name"] = name
    cell["model"] = load_json(base / "configs" / f"{cell['config']}.json")
    return cell


def end_to_end_names(spec: dict, cell: str) -> List[str]:
    return [m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_names(spec: dict, cell: str) -> List[str]:
    """The per-layer metrics a cell's traced run reports: those listing
    it, and those without a list whose ``moves`` the cell reports."""
    e2e = set(end_to_end_names(spec, cell))
    out = []
    for m in spec["per_layer"]:
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else (m["moves"] in e2e):
            out.append(m["name"])
    return out


def metric_units(spec: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in spec["end_to_end"] + spec["per_layer"]}


def load_reader(name: str, base: Path = HERE):
    """``metrics/<name>.py``'s ``read`` function under ``base``."""
    path = base / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read


def load_driver(name: str):
    """The driver module ``<name>.py`` beside this file."""
    return importlib.import_module(f"perfbench.{name}")


def read_metrics(names: List[str], ctx: dict,
                 base: Path = HERE) -> Dict[str, float]:
    """Each reader's value; a reader that finds nothing gives None and
    its metric is left out."""
    out = {}
    for name in names:
        value = load_reader(name, base)(ctx)
        if value is not None:
            out[name] = float(value)
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``paddle_tpu_torch`` is not
    ``paddle_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics, as
    numpy's default) of every value; None for none."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the profiler's reading of a traced sub-window
# ---------------------------------------------------------------------------

def _union(intervals) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_trace(prof, window_s: float, kernels: Dict[str, str]) -> dict:
    """What one profiled sub-window holds: ``busy_s`` (the union of the
    card's kernel, copy and set intervals), ``window_s``, each named
    kernel's device seconds (``kernels``: {key: fragment of the device
    name}), and the breakdown: the ten device operations with most time
    and the ten host activities under which the card idled longest (a
    gap is named by the innermost host event around its middle)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type != DeviceType.CUDA:
            if e > s:
                host.append((s, e, ev.name))
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name.startswith(SPAN_PREFIX)):
            # a span's mirror on the device's timeline is no device work
            device.append((s, e, ev.name))
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    busy = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    host.sort()
    starts = [s for s, _, _ in host]
    idle: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        key = "no host event"
        # host events nest: the innermost one around ``mid`` is the
        # latest-started one that has not ended by then
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                key = host[i][2]
                break
        idle[key] = idle.get(key, 0.0) + (ge - gs) / 1e6
    kern = {k: sum(v for n, v in by_name.items() if frag in n)
            for k, frag in kernels.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "kernel_s": kern,
            "breakdown": {
                "device_ops": [[_short(n), v] for n, v in top],
                "idle_gaps": [[_short(n), v] for n, v in gaps_top]}}


def _short(name: str) -> str:
    """A device or host name cut to 100 characters, template and
    parameter lists dropped where they start past the 40th."""
    for mark in ("(", "<"):
        i = name.find(mark)
        if i > 40:
            name = name[:i]
    return name[:100]


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def device_doc(torch, count: int, peak_bytes: int, trace=None) -> dict:
    doc = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(count), "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        doc["busy_s"] = trace["busy_s"]
        doc["window_s"] = trace["window_s"]
    return doc


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, float], units: Dict[str, str],
                device: dict, checks: Dict[str, tuple],
                breakdown: Optional[dict] = None) -> dict:
    """The last line's object; ``checks`` ({name: (value, limit)}) comes
    last, under ``check``."""
    doc = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        doc["breakdown"] = breakdown
    doc["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in checks.items()}
    return doc


def check_lines(checks: Dict[str, tuple]) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r})"
            for k, (v, lim) in checks.items()]
