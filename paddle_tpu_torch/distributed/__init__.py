"""Distributed helpers (mirrors ``paddle_tpu/distributed``): so far the
flight recorder of ``watchdog.py``."""

from . import watchdog

__all__ = ["watchdog"]
