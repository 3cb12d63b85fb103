#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s engine traces with two trees, in turns, on one
card, to compare them within one call.

    python3 tools/engine_ab.py BEFORE_DIR AFTER_DIR [--rounds 2]

Each tree is a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. Runs alternate (before, after, after, before, ...),
each in a fresh process of its own, which builds that tree's kernels and
calls that tree's ``engine_phase`` for the bf16, int4 and int8 engines of
``chip_smoke.py`` (GPT-2 small widths, random weights from seed 0), with
the profiler where the tree's ``engine_phase`` offers it. Each run's
``engine*:`` lines go to the standard output, prefixed with the run's
label (``before``/``after`` and its index). Exits non-zero when a run
fails. Needs one CUDA card.
"""

import argparse
import subprocess
import sys
from pathlib import Path

ONE_TREE = r'''
import inspect, sys
sys.path.insert(0, {tree!r})
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch.io import lm_serving as tlm
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.serving import PagedDecodeEngine
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.library()
dev = torch.device("cuda:0")
cfg = cs.gpt2_small(tt)
extra = ({{"profiled": True}}
         if "profiled" in inspect.signature(cs.engine_phase).parameters
         else {{}})
params = tt.init_params(cfg, torch.Generator().manual_seed(0), dev)
for kvd, label, branch in ((None, "engine", ""),
                           ("int4", "engine_int4", ".int4")):
    cs.engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev, params,
                    kvd, label, branch, **extra)
del params
fp32 = tt.init_train_params(cfg, torch.Generator().manual_seed(0), "cpu")
w8 = tlm.quantize_lm_params(fp32, device=dev)
cs.engine_phase(torch, tt, kernels, PagedDecodeEngine, cfg, dev, w8, "int8",
                "engine_int8", ".int8", **extra)
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"before": str(Path(args.before).resolve()),
             "after": str(Path(args.after).resolve())}
    order = []
    for r in range(args.rounds):
        order += (["before", "after"] if r % 2 == 0 else ["after", "before"])
    failed = []
    for i, which in enumerate(order):
        code = ONE_TREE.format(tree=trees[which])
        done = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              cwd=trees[which])
        for line in done.stdout.splitlines():
            if line.startswith(("engine", "check engine")):
                print(f"{which}[{i}] {line}", flush=True)
        if done.returncode != 0:
            failed.append(f"{which}[{i}]")
            print(f"{which}[{i}] FAILED ({done.returncode}):\n"
                  f"{done.stderr[-4000:]}", flush=True)
    if failed:
        sys.exit(f"engine_ab: failed runs {failed}")


if __name__ == "__main__":
    main()
