"""Serving-side weight preparation (counterpart of ``paddle_tpu/io/``)."""
