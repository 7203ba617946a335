"""Gradient clipping by global norm (mirrors ``paddle_tpu/nn/clip.py:76``).

scale = clip_norm / max(||g||_2, clip_norm), with the norm summed in
float32 over every gradient. Each gradient is scaled in float32 and cast
back to its own dtype, so a bf16 gradient is rounded before the optimizer
upcasts it for the update, as the JAX package's train step does.
"""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads):
        """sqrt(sum of squares) of ``grads`` in float32 (a 0-d tensor)."""
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        return torch.sqrt(sq)

    def clip(self, grads):
        """Pure form: the clipped gradients, each in its own dtype."""
        grads = list(grads)
        if not grads:
            return grads
        norm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp_min(norm, self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    @torch.no_grad()
    def clip_(self, params):
        """Clip the ``.grad`` of every parameter that has one, in place."""
        params = [p for p in params if p.grad is not None]
        for p, g in zip(params, self.clip([p.grad for p in params])):
            p.grad.copy_(g)
