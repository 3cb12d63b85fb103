"""Stop-aware queue plumbing shared by the producer-thread machinery
(counterpart of ``paddle_tpu/utils/threadq.py``): the ``pipeline/``
stage threads and the ``reader/decorator.py`` worker threads.
Stdlib-only."""

import queue
import time
from typing import List, Sequence


def put_stoppable(q: "queue.Queue", item, stop) -> bool:
    """Backpressured put that stays interruptible: a producer blocked on
    a full queue must notice the consumer's stop event instead of
    hanging. The check comes BEFORE the put — consumers drain the queue
    to wake blocked producers, which keeps the puts succeeding and
    would leave a Full-only check unreached. Returns False on abort."""
    while True:
        if stop.is_set():
            return False
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass


def drain_join(queues: Sequence["queue.Queue"], threads, stop,
               deadline_s: float = 10.0) -> List:
    """Shut down producer threads: signal stop, then keep draining the
    queues (so any blocked put wakes and sees the event) until every
    thread exits or ``deadline_s`` passes. Returns the threads still
    alive at the deadline — a producer stuck inside user code (a socket
    read in a reader fn) cannot be joined; the caller decides whether
    that is a warning (generator close) or an error (pipeline close)."""
    stop.set()
    deadline = time.time() + deadline_s
    alive = [t for t in threads if t.is_alive()]
    while alive and time.time() < deadline:
        for q in queues:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
        for t in alive:
            t.join(timeout=0.05)
        alive = [t for t in alive if t.is_alive()]
    return alive
