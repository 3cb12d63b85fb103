"""The load a serving cell's system sustains: the cell's closed loop at
several client counts, one run each, in one process.

    python3 perfbench/sweep.py --workload xl-chat --clients 32,64,128,192 \\
        --seed <n> --seconds <s>

One JSON line per client count: completed requests per second, output
tokens per second and the tails. The completion rate where tokens per
second stop rising is the knee an open-loop cell's rate is set from.
The benchmark's own runs never run this.
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
    ap.add_argument("--clients", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness, run, serve
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for n in (int(c) for c in args.clients.split(",")):
        cell["traffic"] = dict(cell["traffic"], clients=n,
                               warm_completions=n)
        t0 = time.perf_counter()
        res = serve.run(torch, cell, args.seed, args.seconds, False,
                        torch.device("cuda:0"), t0)
        print(json.dumps({"workload": args.workload, "clients": n,
                          "requests_per_s": res["attempted"]
                          / res["ctx"]["window_s"],
                          **res["e2e"], "correct": res["correct"],
                          "kind": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
