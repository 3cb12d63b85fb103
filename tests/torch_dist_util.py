"""A pool of gloo ranks for the port's multi-rank CPU tests.

The JAX package's distributed tests run one process over 8 virtual CPU
devices; the port runs one process per rank. ``pool()`` starts WORLD
rank processes once per test process (``runtime/launch.spawn_local_procs``
with ``PADDLE_PLATFORM=cpu``; each rank joins a gloo group through
``distributed.init`` with a 60 s group timeout, one thread each, at a
lower CPU priority than the test processes) and
hands them cases over a local socket: ``pool().run("case_name",
inputs=arrays, **kw)`` writes the inputs to an ``.npz``, every rank
calls ``case_name(ctx, **kw)`` of ``tests/torch_dist_cases.py`` and the
per-rank results come back in rank order. A rank that raises fails the
case with its traceback; a rank that dies or hangs past the case's time
limit fails it too, and the pool is torn down (the next case starts a
new one).

This module and the cases import only ``torch``, numpy and the port:
the ranks never import ``jax``.
"""

import atexit
import os
import secrets
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

WORLD = 4
CASE_TIMEOUT_S = 120.0
GROUP_TIMEOUT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_POOL = None


class RankError(AssertionError):
    pass


class RankPool:
    def __init__(self, world: int = WORLD):
        from multiprocessing.connection import Listener

        from paddle_tpu_torch.runtime import launch
        self.world = world
        self.key = secrets.token_bytes(16)
        self.listener = Listener(("127.0.0.1", 0), authkey=self.key)
        host, port = self.listener.address
        self.tmp = tempfile.mkdtemp(prefix="torch-ranks-")
        # the launcher writes no platform (the card by default): the
        # pool asks for gloo on the CPU
        env = {"PYTHONPATH": REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               "PADDLE_PLATFORM": "cpu",
               "PADDLE_DIST_TIMEOUT_S": str(GROUP_TIMEOUT_S),
               "TORCH_RANK_POOL": f"{host}:{port}:{self.key.hex()}",
               "OMP_NUM_THREADS": "1"}
        self.procs = launch.spawn_local_procs(
            world, ["-m", "tests.torch_dist_util"], env_extra=env)
        self.conns = [None] * world
        self.listener._listener._socket.settimeout(CASE_TIMEOUT_S)
        try:
            for _ in range(world):
                c = self.listener.accept()
                rank = c.recv()
                self.conns[rank] = c
        except Exception:
            self.close()
            raise

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def run(self, case: str, inputs=None, timeout: float = CASE_TIMEOUT_S,
            **kw):
        """Every rank runs ``case``; the list of per-rank results."""
        path = None
        if inputs is not None:
            path = os.path.join(self.tmp, f"in-{secrets.token_hex(4)}.npz")
            np.savez(path, **inputs)
        try:
            for c in self.conns:
                c.send((case, path, kw))
            out = [None] * self.world
            deadline = time.monotonic() + timeout
            for r, c in enumerate(self.conns):
                try:
                    while not c.poll(0.2):
                        if time.monotonic() > deadline or not self.alive():
                            raise EOFError
                    ok, val = c.recv()
                except (EOFError, OSError):
                    codes = [p.poll() for p in self.procs]
                    self.close()
                    raise RankError(
                        f"case {case}: rank {r} gave no result (exit "
                        f"codes {codes}); pool torn down") from None
                if not ok:
                    out[r] = RankError(f"rank {r} of case {case}:\n{val}")
                else:
                    out[r] = val
            errs = [o for o in out if isinstance(o, RankError)]
            if errs:
                raise errs[0]
            return out
        finally:
            if path:
                os.unlink(path)

    def close(self):
        from paddle_tpu_torch.runtime import launch
        for c in self.conns:
            if c is not None:
                try:
                    c.send(None)
                except OSError:
                    pass
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and any(
                p.poll() is None for p in self.procs):
            time.sleep(0.05)
        launch.terminate_procs(self.procs, grace=2.0)
        self.listener.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
        global _POOL
        if _POOL is self:
            _POOL = None


def pool() -> RankPool:
    """The test process's pool of WORLD ranks (started on first use)."""
    global _POOL
    if _POOL is not None and not _POOL.alive():
        _POOL.close()
    if _POOL is None:
        _POOL = RankPool(WORLD)
    return _POOL


@atexit.register
def _shutdown():
    if _POOL is not None:
        _POOL.close()


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

def _serve():
    from multiprocessing.connection import Client

    import torch
    torch.set_num_threads(1)
    # the ranks yield the cores to the test processes beside them (the
    # JAX package's multi-device tests wait on each other's threads)
    os.nice(10)
    host, port, key = os.environ["TORCH_RANK_POOL"].split(":")
    from paddle_tpu_torch import distributed
    distributed.init()
    rank = distributed.process_index()
    conn = Client((host, int(port)), authkey=bytes.fromhex(key))
    conn.send(rank)
    from tests import torch_dist_cases as cases
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, path, kw = msg
        try:
            inputs = dict(np.load(path)) if path else {}
            ctx = cases.Ctx(rank, distributed.process_count(), inputs)
            conn.send((True, getattr(cases, name)(ctx, **kw)))
        except Exception:        # the case's failure goes to the test
            conn.send((False, traceback.format_exc()))
    distributed.shutdown()


if __name__ == "__main__":
    sys.exit(_serve())
