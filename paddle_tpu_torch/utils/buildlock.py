"""One build per output directory across processes.

The port builds native code at first use: the Hopper kernels
(``ops/kernels/_build.py``) and the record codec (``runtime/native``),
each into a directory keyed by its sources under ``build/``. Several
processes can meet a cold directory at once (the replicas of a fleet
start together), and a build writes fixed-name objects there. So a
build holds an exclusive ``flock`` on the directory's ``.build.lock``
file and looks for the finished library again once it holds it: the
first process compiles, the others wait and load what it published.
"""

import contextlib
import fcntl
import os
from pathlib import Path

LOCK_NAME = ".build.lock"


@contextlib.contextmanager
def build_lock(out_dir):
    """Hold the exclusive build lock of ``out_dir`` (made if missing).
    Blocks while another process, or another open of the lock file in
    this one, holds it; released on exit, and by the kernel if the
    holder dies."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd = os.open(out_dir / LOCK_NAME, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield out_dir
    finally:
        os.close(fd)            # closing the descriptor drops the lock
