"""Optimizers, gradient clipping and learning-rate schedulers.
Counterpart: ``paddle_tpu/optimizer``."""
from . import lr  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
