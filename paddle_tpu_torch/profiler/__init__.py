from . import metrics

__all__ = ["metrics"]
