from .vit import (VisionTransformer, ViTConfig, vit_b_16, vit_h_14,
                  vit_l_16)

__all__ = ["VisionTransformer", "ViTConfig", "vit_b_16", "vit_h_14",
           "vit_l_16"]
