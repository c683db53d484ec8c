"""Utilities. Counterpart: ``paddle_tpu/utils``."""
