"""Self-speculative draft proposal: prompt-lookup (n-gram) decoding
(mirrors ``paddle_tpu/serving/spec.py``).

The cheapest useful draft model is the request's own context: text
repeats itself (boilerplate, quoted spans, loops), and greedy LLM
continuations fall into repetition, so "find the most recent earlier
occurrence of the trailing n-gram and propose what followed it" predicts
the model's own next tokens far more often than chance, for no extra
parameters and no device work (prompt-lookup decoding, vLLM's
``[ngram]`` speculative model).

``Scheduler._decode_spec`` calls :func:`propose_draft` per running
request, verifies all drafts in one batched multi-position paged sweep
(``Llama.paged_spec_step``), accepts the longest greedy-matching prefix
and rolls rejected rows back: every accepted token is the model's own
argmax, so greedy outputs equal non-speculative decode's. Proposal is
host numpy over a context of at most ``max_seq_len`` tokens.

Flags: ``FLAGS_serving_spec`` (off by default), ``FLAGS_serving_spec_
tokens`` (k), ``FLAGS_serving_spec_ngram`` (the longest match tried).
"""

from __future__ import annotations

import numpy as np

__all__ = ["propose_draft", "REPETITIVE_CORPUS", "repetitive_prompts"]

# The reference's high-acceptance evaluation corpus: (seed, size) pairs
# whose greedy continuation under the JAX package's seed-0 tiny Llama
# repeats itself, so prompt-lookup drafts keep matching. The CPU parity
# tests serve it through both packages.
REPETITIVE_CORPUS = ((9, 9), (12, 9), (12, 12), (14, 6))


def repetitive_prompts():
    """:data:`REPETITIVE_CORPUS` as int prompt arrays."""
    return [np.random.default_rng(seed).integers(3, 250, size=size)
            for seed, size in REPETITIVE_CORPUS]


def propose_draft(context, max_tokens, ngram_max=3):
    """Up to ``max_tokens`` draft tokens continuing ``context`` (1-D int
    array: prompt + everything generated so far).

    Tries the trailing ``n``-gram for ``n = ngram_max .. 1``: the most
    recent prior occurrence wins, and the tokens that followed it are the
    draft. Returns an int64 array, possibly empty (nothing repeats; the
    scheduler then decodes that slot plainly). Pure and deterministic."""
    ids = np.ascontiguousarray(np.asarray(context).reshape(-1),
                               dtype=np.int64)
    n = int(ids.size)
    if n < 2 or max_tokens <= 0:
        return np.empty((0,), np.int64)
    for g in range(min(int(ngram_max), n - 1), 0, -1):
        tail = ids[n - g:]
        windows = np.lib.stride_tricks.sliding_window_view(ids, g)
        matches = np.flatnonzero((windows == tail).all(axis=1))
        # the last window is the tail itself; only earlier occurrences
        # have a continuation
        matches = matches[matches < n - g]
        if matches.size:
            j = int(matches[-1])
            cont = ids[j + g:j + g + int(max_tokens)]
            if cont.size:
                return cont.copy()
    return np.empty((0,), np.int64)
