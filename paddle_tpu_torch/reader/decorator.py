"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
reference: python/paddle/v2/reader/decorator.py:26-292 — map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers). Worker
threads are named ``reader-*``. ``shuffle`` draws from
``random.Random`` with the JAX package's seed folding, so a seeded
shuffle gives that package's order."""

import itertools
import queue
import random
import threading

from paddle_tpu_torch.utils.threadq import put_stoppable as _put_stoppable


def map_readers(func, *readers):
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


_shuffle_ids = itertools.count()


def shuffle(reader_fn, buf_size, seed=None):
    """Pool-shuffle within a bounded buffer (reference: decorator.py:68).

    Seeding: an explicit ``seed`` wins; else the framework seed flag (set by
    ``paddle.init(seed=...)``) makes seeded runs reproducible end-to-end; else
    the global ``random`` module is used, preserving the reference's
    ``random.seed()``-before-building-readers idiom. Each shuffle() call and
    each pass derive distinct orders (decoration id + pass count folded in)."""
    dec_id = next(_shuffle_ids)
    calls = itertools.count()

    def reader():
        n = next(calls)
        base = seed
        if base is None:
            from paddle_tpu_torch.utils.flags import GLOBAL_FLAGS
            s = GLOBAL_FLAGS.get("seed", 0)
            base = s if s else None
        if base is None:
            rng = random  # reference behavior: the global random module
        else:
            rng = random.Random((base * 1000003 + dec_id) * 1000003 + n)
        buf = []
        for e in reader_fn():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf
    return reader


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])
    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (reference: decorator.py:125)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield sum((make_tuple(i) for i in items), ())
    return reader


def _close_workers(queues, threads, stop):
    """Generator-close path: join the worker threads (waking any blocked
    put by draining), warning instead of hanging when one is stuck
    inside user code — close() must always return."""
    from paddle_tpu_torch.utils.threadq import drain_join
    leaked = drain_join(queues, threads, stop)
    if leaked:
        from paddle_tpu_torch.utils.logger import get_logger
        get_logger("reader").warning(
            "reader close: %d worker thread(s) still blocked in user "
            "code after 10s (%s) — abandoning them as daemons",
            len(leaked), ", ".join(t.name for t in leaked))


def buffered(reader_fn, size):
    """Thread-prefetch up to `size` samples (reference: decorator.py:180).
    Source exceptions propagate to the consumer rather than silently
    truncating the stream; closing the generator mid-iteration (break,
    GC) joins the fill thread instead of leaking it blocked on a full
    queue."""
    end = object()

    def reader():
        q = queue.Queue(maxsize=size)
        stop = threading.Event()

        def fill():
            try:
                for e in reader_fn():
                    if not _put_stoppable(q, e, stop):
                        return
                _put_stoppable(q, end, stop)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                _put_stoppable(q, (end, exc), stop)

        t = threading.Thread(target=fill, name="reader-buffered",
                             daemon=True)
        t.start()
        try:
            while True:
                e = q.get()
                if e is end:
                    break
                if isinstance(e, tuple) and len(e) == 2 and e[0] is end:
                    raise e[1]
                yield e
        finally:
            _close_workers([q], [t], stop)
    return reader


def firstn(reader_fn, n):
    def reader():
        return itertools.islice(reader_fn(), n)
    return reader


def cache(reader_fn):
    """Materialise once, replay from memory."""
    data = []
    filled = []

    def reader():
        if not filled:
            data.extend(reader_fn())
            filled.append(True)
        return iter(data)
    return reader


def xmap_readers(mapper, reader_fn, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (reference:
    decorator.py:229 XmapEndSignal machinery).

    Failure semantics: a SOURCE exception (the feed thread) poisons the
    workers and re-raises at the consumer — previously the feed thread
    died silently, the workers blocked on an empty in-queue forever, and
    the consumer hung. Worker (mapper) exceptions re-raise at the
    consumer as before. Closing the generator early joins every thread
    (no daemon-thread leak after partial iteration)."""
    end = object()

    def reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        stop = threading.Event()

        def feed():
            try:
                for i, s in enumerate(reader_fn()):
                    if not _put_stoppable(in_q, (i, s), stop):
                        return
                for _ in range(process_num):
                    if not _put_stoppable(in_q, end, stop):
                        return
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                # the consumer must see the source failure (not hang),
                # and the workers must still be released
                _put_stoppable(out_q, (end, exc), stop)
                for _ in range(process_num):
                    if not _put_stoppable(in_q, end, stop):
                        return

        def work():
            try:
                while True:
                    try:
                        item = in_q.get(timeout=0.1)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is end:
                        _put_stoppable(out_q, end, stop)
                        break
                    i, s = item
                    if not _put_stoppable(out_q, (i, mapper(s)), stop):
                        return
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                _put_stoppable(out_q, (end, exc), stop)

        threads = [threading.Thread(target=feed, name="reader-xmap-feed",
                                    daemon=True)]
        threads += [threading.Thread(target=work,
                                     name="reader-xmap-worker",
                                     daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        def classify(item):
            """Returns 'end' or 'data'; raises propagated errors."""
            if item is end:
                return "end"
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                raise item[1]
            return "data"

        try:
            finished = 0
            if not order:
                while finished < process_num:
                    item = out_q.get()
                    if classify(item) == "end":
                        finished += 1
                    else:
                        yield item[1]
            else:
                pending, want = {}, 0
                while finished < process_num or pending:
                    if want in pending:
                        yield pending.pop(want)
                        want += 1
                        continue
                    if finished >= process_num:
                        break  # workers done, a gap remains (dropped index)
                    item = out_q.get()
                    if classify(item) == "end":
                        finished += 1
                    else:
                        pending[item[0]] = item[1]
        finally:
            _close_workers([in_q, out_q], threads, stop)
    return reader
