"""Parallel attention engines (counterpart of ``paddle_tpu/parallel/``)."""
