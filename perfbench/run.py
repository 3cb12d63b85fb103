"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the result's JSON object;
the numbers ``correct`` was decided on, each beside its limit, are the
last lines of standard error. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. Exit codes:
0 with a result; 2 for an unknown cell; 3 without the cards the cell
needs; 4 when JAX or the JAX package was loaded; 1 for any other
failure.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (the module's own start where that is
    unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()
ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"


def cache_env():
    """Every build and kernel cache in fixed directories of the
    checkout, and no library loading JAX on its own."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    try:
        cell = harness.load_cell(args.workload)
    except KeyError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    spec = harness.benchmark_spec()
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), 1)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    driver = harness.load_driver(cell["driver"])
    out = driver.run(torch, cell, args.seed, args.seconds, bool(args.trace),
                     device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 4
    line = compose(torch, spec, cell, out, bool(args.trace), chips)
    for text in harness.check_lines(out["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def compose(torch, spec: dict, cell: dict, out: dict, trace: bool,
            chips: int) -> dict:
    from perfbench import harness
    name = cell["name"]
    units = harness.metric_units(spec)
    if trace:
        metrics = harness.read_metrics(harness.per_layer_names(spec, name),
                                       out["ctx"])
    else:
        metrics = {k: out["e2e"][k]
                   for k in harness.end_to_end_names(spec, name)
                   if out["e2e"].get(k) is not None}
    traced = out["trace"] if trace else None
    return harness.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"], metrics=metrics, units=units,
        device=harness.device_doc(torch, chips, out["peak_bytes"], traced),
        checks=out["checks"],
        breakdown=traced["breakdown"] if traced else None)


if __name__ == "__main__":
    sys.exit(main())
