from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .conv import Conv2D
from .fused_ce import fused_linear_cross_entropy
from .layers import (GELU, Dropout, Embedding, LayerList, LayerNorm, Linear,
                     RMSNorm, Sequential)
from .transformer import MultiHeadAttention

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Conv2D",
           "Dropout", "Embedding", "GELU", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "Sequential",
           "fused_linear_cross_entropy"]
