"""paddle.batch (counterpart of ``paddle_tpu/reader/minibatch.py``;
reference: python/paddle/v2/minibatch.py)."""


def batch(reader_fn, batch_size, drop_last=True):
    """Group samples into lists of batch_size. ``drop_last`` defaults to
    True, as in the JAX package: a ragged final batch is a new feed
    signature for one step."""
    def reader():
        b = []
        for sample in reader_fn():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return reader
