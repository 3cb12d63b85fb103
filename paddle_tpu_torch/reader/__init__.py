"""Readers (counterpart of ``paddle_tpu/reader/``; reference:
python/paddle/v2/reader/): a reader is a zero-arg callable returning an
iterable of samples. The creators (``np_array``, ``text_file``,
``recordio``), the decorators that compose them and ``minibatch.batch``
(``paddle_tpu_torch.batch``) are all live."""

from paddle_tpu_torch.reader import creator  # noqa: F401
from paddle_tpu_torch.reader import minibatch  # noqa: F401
from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    buffered, cache, chain, compose, firstn, map_readers, shuffle,
    xmap_readers,
)
