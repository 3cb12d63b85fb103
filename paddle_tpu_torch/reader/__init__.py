"""Readers (counterpart of ``paddle_tpu/reader/``): a reader is a
zero-arg callable returning an iterable of samples. The port holds
``minibatch.batch`` (``paddle_tpu_torch.batch``); the creators and
decorators come with the data remainder (ROADMAP A8)."""

from paddle_tpu_torch.reader import minibatch  # noqa: F401
