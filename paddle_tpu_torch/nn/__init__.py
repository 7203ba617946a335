from . import functional
from .clip import ClipGradByGlobalNorm
from .fused_ce import fused_linear_cross_entropy
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RMSNorm", "fused_linear_cross_entropy"]
