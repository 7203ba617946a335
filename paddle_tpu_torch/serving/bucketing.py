"""Prefill length bucketing (mirrors ``paddle_tpu/serving/bucketing.py``).

A prompt's padded prefill length rounds up to the next power of two
(capped by ``FLAGS_serving_prefill_bucket_cap``), so the shapes a warm
server runs are a bounded ladder: ``ServingEngine.warmup()`` visits each
of them once, and on the GPU every kernel of the path is built and first
launched before live traffic arrives. Lengths beyond the cap fall back
to plain block-multiple padding.

The extra padding is dead compute only: positions past the true length
are masked in attention, and pool writes past the slot's allocated
blocks land in null block 0 (see ``Llama.paged_prefill``). Chunk hashes
are computed over the unpadded token ids before any bucketing: padding
must never reach a content hash. Cache-hitting admissions bucket only
their uncovered tail.
"""

from __future__ import annotations

__all__ = ["bucket_length", "bucket_lengths"]


def _round_up(n, multiple):
    return -(-n // multiple) * multiple


def bucket_length(n_tokens, block_size, cap, max_len=None):
    """Padded prefill length for a prompt of ``n_tokens``.

    Power-of-two bucket >= n_tokens (and >= block_size), rounded up to a
    block multiple, as long as the bucket fits under ``cap``; otherwise
    the plain block-multiple pad. ``max_len`` (the cache's
    max_blocks_per_seq * block_size) clamps the result either way.
    """
    if n_tokens < 1:
        raise ValueError(f"bucket_length: n_tokens must be >= 1, "
                         f"got {n_tokens}")
    base = _round_up(n_tokens, block_size)
    out = base
    if cap and cap > 0:
        p = max(block_size, 1)
        while p < n_tokens:
            p <<= 1
        p = _round_up(max(p, base), block_size)
        if p <= cap:
            out = p
    if max_len is not None:
        # clamp to the cache's capacity, but never below the minimal
        # block-multiple pad (callers validate n_tokens <= max_len)
        out = max(min(out, _round_up(max_len, block_size)), base)
    return out


def bucket_lengths(block_size, cap, max_len):
    """Every bucket a serving configuration can produce, ascending: what
    a warm-up loop prefills through."""
    out, seen = [], set()
    n = 1
    while n <= max_len:
        b = bucket_length(n, block_size, cap, max_len)
        if b not in seen:
            seen.add(b)
            out.append(b)
        n = b + 1
    return out
