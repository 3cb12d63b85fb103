"""Length buckets (counterpart of ``paddle_tpu/core/ragged.py``,
``bucket_length`` and ``DEFAULT_BUCKETS`` only)."""

from typing import Sequence

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; beyond the last bucket, round up to a
    multiple of it."""
    for b in buckets:
        if n <= b:
            return int(b)
    last = int(buckets[-1])
    return ((int(n) + last - 1) // last) * last
