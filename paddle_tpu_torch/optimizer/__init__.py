from .adam import Adam, AdamW, adam_update
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "adam_update"]
