"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``;
reference: python/paddle/v2/reader/creator.py — np_array, text_file,
recordio)."""

import numpy as np


def np_array(x):
    def reader():
        yield from np.asarray(x)
    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")
    return reader


def recordio(paths):
    """Read chunked record files written by ``runtime/recordio`` of
    either package (replaces the Go recordio reader used for cloud
    datasets)."""
    from paddle_tpu_torch.runtime import recordio as rio
    if isinstance(paths, str):
        paths = [paths]

    def reader():
        for p in paths:
            yield from rio.read_records(p)
    return reader
