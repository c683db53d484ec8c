from . import moe  # noqa: F401

__all__ = ["moe"]
