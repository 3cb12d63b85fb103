"""The port's copy of ``paddle_tpu/dataset/common.py``.

Dataset cache helpers (reference: python/paddle/v2/dataset/common.py:62 —
download cache under ~/.cache/paddle/dataset, md5 check, cluster file split)."""

import hashlib
import os

from paddle_tpu_torch.utils.logger import get_logger

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))

log = get_logger("dataset")
_warned = set()


def real_data(reader_fn):
    """Mark a reader as backed by real cached files."""
    reader_fn.provenance = "real"
    return reader_fn


def synthetic_fallback(module: str, split: str, reader_fn):
    """Mark a reader as synthetic and warn LOUDLY, once per module/split.

    A run that silently trains on noise believing it trained the real
    dataset is worse than a crash — the provenance attribute lets callers
    (and tests) assert what they actually consumed."""
    key = (module, split)
    if key not in _warned:
        _warned.add(key)
        log.warning(
            "dataset %s.%s: no cached real data under %s — using SYNTHETIC "
            "schema-compatible data. Results do NOT reflect the real "
            "dataset; drop the reference files into the cache dir to fix.",
            module, split, os.path.join(DATA_HOME, module))
    reader_fn.provenance = "synthetic"
    return reader_fn


def cache_path(module: str, filename: str) -> str:
    return os.path.join(DATA_HOME, module, filename)


def cached_file(module: str, filename: str, md5=None):
    """Return the cached path if present (and md5-valid), else None.
    (No download: the files are placed under DATA_HOME beforehand; the
    reference's download() lives here in spirit.)"""
    path = cache_path(module, filename)
    if not os.path.exists(path):
        return None
    if md5:
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != md5:
            return None
    return path


def split(reader_fn, line_count, suffix_formatter=None):
    """Cluster split helper (reference: common.py split/cluster_files) —
    partition a reader into chunks for the task-dispatch data service.
    Streams: yields one chunk at a time, holding only ``line_count`` samples
    in memory (the recordio/task design it feeds is streaming too)."""
    current = []
    for sample in reader_fn():
        current.append(sample)
        if len(current) >= line_count:
            yield current
            current = []
    if current:
        yield current


def split_to_recordio(reader_fn, path_pattern, line_count=1024):
    """Materialise a reader into recordio files of ``line_count`` records
    each — the cluster_files path (reference: common.py convert-to-recordio
    for cloud training). path_pattern must contain one ``%d``/``{}`` slot;
    returns the written paths."""
    import re as _re

    from paddle_tpu_torch.runtime import recordio

    has_pct_slot = _re.search(r"%[0-9]*[ds]", path_pattern) is not None

    def render(i):
        return path_pattern % i if has_pct_slot else path_pattern.format(i)

    if render(0) == render(1):
        raise ValueError(
            f"path_pattern {path_pattern!r} has no %d/{{}} slot — every "
            f"chunk would overwrite the previous one")
    paths = []
    for i, chunk in enumerate(split(reader_fn, line_count)):
        path = render(i)
        recordio.write_records(path, chunk)
        paths.append(path)
    return paths


def convert(output_path, reader_fn, line_count, name_prefix):
    """Convert a reader to recordio chunk files named
    ``<name_prefix>-%05d`` under output_path (reference: common.py:194 —
    the cloud-training preprocessing step feeding the master's task
    dispatch). Returns the written paths."""
    os.makedirs(output_path, exist_ok=True)
    pattern = os.path.join(output_path, f"{name_prefix}-%05d")
    return split_to_recordio(reader_fn, pattern, line_count)
