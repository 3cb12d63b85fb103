"""Logging — the port's own copy of ``paddle_tpu/utils/logger.py``: one
``paddle_tpu_torch`` logger on stderr, its level from
``PADDLE_TPU_LOGLEVEL``. Unlike the JAX package's logger it propagates,
so handlers on the root logger (pytest's ``caplog``) still see the
port's records."""

import logging
import os
import sys

_LOGGER = logging.getLogger("paddle_tpu_torch")

if not _LOGGER.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "%(levelname).1s %(asctime)s %(name)s %(filename)s:%(lineno)d] "
        "%(message)s", datefmt="%m%d %H:%M:%S"))
    _LOGGER.addHandler(_handler)
    _level = os.environ.get("PADDLE_TPU_LOGLEVEL", "INFO").upper()
    if _level not in logging.getLevelNamesMapping():
        _LOGGER.warning("invalid PADDLE_TPU_LOGLEVEL=%r, using INFO", _level)
        _level = "INFO"
    _LOGGER.setLevel(_level)


def get_logger(name=None):
    return _LOGGER.getChild(name) if name else _LOGGER
