"""Token sampling (mirrors ``paddle_tpu/models/generation.py:22``).

The JAX package draws from ``jax.random`` keys; here an explicit
``torch.Generator`` is the source. The two give different draws from the
same seed, so only greedy decoding is comparable across packages.
"""

from __future__ import annotations

import torch

__all__ = ["sample_token"]


def sample_token(logits, temperature=1.0, top_k=0, top_p=1.0,
                 generator=None):
    """logits [b, vocab] -> [b] int64 token ids. ``temperature == 0`` is
    greedy argmax; otherwise top-k then top-p filtering and a categorical
    draw from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
        # clamped: where the float32 sum never reaches top_p the count is
        # V, which the reference's take_along_axis reads as NaN (every
        # token kept); the last (smallest) logit keeps every token too
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
