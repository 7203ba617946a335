"""``optimizer`` (mirrors ``paddle_tpu/optimizer/__init__.py``)."""

from . import lr
from .adam import Adam, Adamax, AdamW, Lamb, NAdam, RAdam
from .lbfgs import LBFGS
from .optimizer import (
    ASGD, SGD, Adadelta, Adagrad, Momentum, Optimizer, RMSProp, Rprop,
)

__all__ = ["lr", "ASGD", "SGD", "Adadelta", "Adagrad", "Adam", "Adamax",
           "AdamW", "LBFGS", "Lamb", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop"]
