"""Readings for the limits that decide ``correct``: the program's and
the control's, seed after seed in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--out <file.jsonl>]

For each seed the cell runs as ``run.py`` runs it (a window of
``--seconds``) and then puts the control in the program's place: for a
serving cell the fp8 reference's widest gap on the same prompts and
served tokens, for the training cell the fp8 reference's and the
half-batch fault's three steps against the fp32 reference. One JSON
line per seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness, run
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell["driver"])
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = driver.run(torch, cell, seed, args.seconds, False, device, t0,
                         control=True)
        doc = {"workload": args.workload, "seed": seed,
               "correct": res["correct"], "attempted": res["attempted"],
               "failed": res["failed"],
               "checks": {k: v for k, (v, _) in res["checks"].items()},
               "control": res["control"], "e2e": res["e2e"],
               "peak_bytes": res["peak_bytes"],
               "run_s": time.perf_counter() - t0,
               "kind": torch.cuda.get_device_name(0)}
        print(json.dumps(doc), flush=True)
        if out:
            out.write(json.dumps(doc) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
