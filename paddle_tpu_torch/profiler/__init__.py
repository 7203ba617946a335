from . import accounting, metrics, tracing

__all__ = ["accounting", "metrics", "tracing"]
