#!/usr/bin/env python3
"""Wall time of each kernel source's ``nvcc``, on a machine with the CUDA
toolkit.

    python3 tools/build_times.py

Compiles every ``paddle_tpu_torch/ops/kernels/csrc`` source with the flags
of ``ops/kernels/_build.py``, first all together as the build runs them
(the seconds at which each finished), then one at a time (each one's own
seconds), into a temporary directory; nothing is linked or kept. The
build's wall time is its slowest source's when the machine has a core for
each; this shows which source that is.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.ops.kernels import _build  # noqa: E402


def _cmd(nvcc, src, out):
    return [nvcc, *_build.NVCC_FLAGS, "-c", str(_build.CSRC / src), "-o",
            str(Path(out) / (src + ".o"))]


def main():
    nvcc = _build.nvcc_path()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        procs = {s: subprocess.Popen(_cmd(nvcc, s, out),
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
                 for s in _build.SOURCES}
        together = {}
        while len(together) < len(procs):
            for s, p in procs.items():
                if s not in together and p.poll() is not None:
                    if p.returncode:
                        sys.exit(f"nvcc failed on {s}")
                    together[s] = round(time.perf_counter() - t0, 1)
            time.sleep(0.1)
        alone = {}
        for s in _build.SOURCES:
            t = time.perf_counter()
            subprocess.run(_cmd(nvcc, s, out), check=True,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
            alone[s] = round(time.perf_counter() - t, 1)
    print(json.dumps({"together_s": together, "alone_s": alone}))


if __name__ == "__main__":
    main()
