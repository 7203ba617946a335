"""Fused (blockwise) LM-head linear + softmax cross entropy (mirrors
``paddle_tpu/nn/functional/fused_ce.py:42-192``).

The [N, V] logits never exist whole: the vocab is scanned in K-wide chunks
(K = min(8192, V): C full chunks plus an R-wide remainder, no padding)
carrying the online max / sum-exp from -1e30 and the label logit. The
backward recomputes each chunk's logits and accumulates dx in float32
(cast to x's dtype once) and writes dW chunk by chunk in W's dtype. Peak
extra memory is one [N, K] float32 chunk.

Chunk logits are float32: the operands are upcast, so a bf16 model's
products are exact and accumulate in float32, as the JAX package's
``preferred_element_type=float32`` products do. The chunk products are
plain ``torch.matmul``: the JAX package computes them outside any Pallas
kernel too.
"""

from __future__ import annotations

import torch

_INIT_MAX = -1e30  # finite lowest: keeps exp(m - m_new) NaN-free


def chunk_plan(V):
    """(K, C, R): C full K-wide chunks plus an R-wide remainder."""
    K = min(8192, V)
    C = V // K
    return K, C, V - C * K


def _chunks(V):
    K, C, R = chunk_plan(V)
    out = [(c * K, K) for c in range(C)]
    if R:
        out.append((C * K, R))
    return out


def _w_chunk(w, start, size, transpose_w):
    """The chunk as [size, D] (float32), whichever layout ``w`` has."""
    wc = w[start:start + size] if transpose_w else \
        w[:, start:start + size].t()
    return wc.float()


class _FusedCE(torch.autograd.Function):
    """x2 [N, D], w [V, D] (``transpose_w``) or [D, V], labels [N] ->
    per-token loss [N] float32 (0 where the label is ``ignore_index``)."""

    @staticmethod
    def forward(ctx, x2, w, lbl, transpose_w, ignore_index):
        V = w.shape[0] if transpose_w else w.shape[1]
        N = x2.shape[0]
        xf = x2.float()
        m = torch.full((N,), _INIT_MAX, device=x2.device,
                       dtype=torch.float32)
        s = torch.zeros(N, device=x2.device, dtype=torch.float32)
        ll = torch.zeros(N, device=x2.device, dtype=torch.float32)
        for start, size in _chunks(V):
            logits = xf @ _w_chunk(w, start, size, transpose_w).t()
            m_new = torch.maximum(m, logits.amax(1))
            s = s * torch.exp(m - m_new) + \
                torch.exp(logits - m_new[:, None]).sum(1)
            col = lbl - start
            hit = (col >= 0) & (col < size)
            picked = logits.gather(1, col.clamp(0, size - 1)[:, None])[:, 0]
            ll = ll + torch.where(hit, picked, torch.zeros_like(picked))
            m = m_new
        log_z = m + torch.log(s)
        valid = lbl != ignore_index
        per_tok = torch.where(valid, log_z - ll, torch.zeros_like(ll))
        ctx.save_for_backward(x2, w, lbl, log_z, valid)
        ctx.transpose_w = transpose_w
        return per_tok

    @staticmethod
    def backward(ctx, g):
        x2, w, lbl, log_z, valid = ctx.saved_tensors
        transpose_w = ctx.transpose_w
        V = w.shape[0] if transpose_w else w.shape[1]
        gi = g.float() * valid.float()
        xf = x2.float()
        dx = torch.zeros_like(xf)
        dw = torch.empty_like(w)
        for start, size in _chunks(V):
            wc = _w_chunk(w, start, size, transpose_w)      # [size, D]
            logits = xf @ wc.t()
            delta = torch.exp(logits - log_z[:, None])
            col = lbl - start
            hit = (col >= 0) & (col < size)
            delta.scatter_add_(1, col.clamp(0, size - 1)[:, None],
                               -hit.float()[:, None])  # p - onehot
            delta = delta * gi[:, None]  # ignored tokens zero out here
            dx += delta @ wc
            dwc = (delta.t() @ xf).to(w.dtype)               # [size, D]
            if transpose_w:
                dw[start:start + size] = dwc
            else:
                dw[:, start:start + size] = dwc.t()
        return dx.to(x2.dtype), dw, None, None, None


def fused_linear_cross_entropy(x, weight, labels, transpose_weight=False,
                               ignore_index=-100, reduction="mean"):
    """CE(x @ W, labels) without the [N, V] logits.

    x: [..., D] hidden states; weight: [D, V], or [V, D] with
    ``transpose_weight=True`` (the tied-embedding layout, and every port
    ``Linear`` weight); labels: [...] ints, ``ignore_index`` rows add 0.
    reduction: ``mean`` (over non-ignored labels, divisor at least 1),
    ``sum`` or ``none``.
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    lbl = labels.reshape(-1).long()
    per_tok = _FusedCE.apply(x2, weight, lbl, bool(transpose_weight),
                             ignore_index)
    if reduction == "none":
        return per_tok.reshape(lead)
    if reduction == "sum":
        return per_tok.sum()
    n_valid = (lbl != ignore_index).sum().float()
    return per_tok.sum() / torch.clamp_min(n_valid, 1.0)
