"""Observability: metrics registry and MFU accounting."""
