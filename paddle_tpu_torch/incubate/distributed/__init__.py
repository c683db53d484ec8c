from . import models  # noqa: F401

__all__ = ["models"]
