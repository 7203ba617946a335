"""Autoregressive generation and token sampling (mirrors
``paddle_tpu/models/generation.py``).

``generate`` runs a model with contiguous KV caches (``init_cache``,
``forward(ids, caches=..., position_offset=...)``: Llama) as one prefill
and one forward a new token; a model without ``init_cache`` (the port's
GPT), or ``use_cache=False``, takes ``_generate_no_cache``, the whole
context every step. Both keep the JAX package's eos contract: a row that
emitted ``eos_token_id`` keeps emitting it, and once every row is done
the rest fills with it without further model calls.

The JAX package draws from ``jax.random`` keys; here an explicit
``torch.Generator`` is the source. The two give different draws from the
same seed, so only greedy decoding is comparable across packages.
"""

from __future__ import annotations

import torch

__all__ = ["generate", "sample_token"]


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


def generate(model, input_ids, max_new_tokens=32, temperature=0.0,
             top_k=0, top_p=1.0, eos_token_id=None, use_cache=True,
             generator=None):
    """Greedy (``temperature`` 0) or sampled decoding of ``input_ids``
    [b, prompt] (a tensor or array): returns int64 [b, prompt +
    max_new_tokens] on the model's device."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(input_ids, device=dev).long()
    if not (use_cache and hasattr(model, "init_cache")):
        return _generate_no_cache(model, ids, max_new_tokens, temperature,
                                  top_k, top_p, eos_token_id, generator)
    b, prompt_len = ids.shape
    with torch.inference_mode():
        caches = model.init_cache(b, prompt_len + max_new_tokens)
        logits, caches = model(ids, caches=caches, position_offset=0)
        tok = sample_token(logits[:, -1], temperature, top_k, top_p,
                           generator)
        out_tokens = [tok]
        done = torch.zeros(b, dtype=torch.bool, device=ids.device)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
        for t in range(1, max_new_tokens):
            logits, caches = model(tok[:, None], caches=caches,
                                   position_offset=prompt_len + t - 1)
            tok = sample_token(logits[:, -1], temperature, top_k, top_p,
                               generator)
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id),
                                  tok)
                done = done | (tok == eos_token_id)
                out_tokens.append(tok)
                if bool(done.all()):
                    out_tokens.extend(
                        [torch.full_like(tok, eos_token_id)] *
                        (max_new_tokens - 1 - t))
                    break
            else:
                out_tokens.append(tok)
        gen = torch.stack(out_tokens, dim=1).to(ids.dtype)
        return torch.cat([ids, gen], dim=1)


def _generate_no_cache(model, ids, max_new_tokens, temperature, top_k,
                       top_p, eos_token_id, generator=None):
    """Full-context decoding for models without a cache: one forward of
    the whole sequence per new token, with ``generate``'s eos contract."""
    with torch.inference_mode():
        out = ids
        b = ids.shape[0]
        done = torch.zeros(b, dtype=torch.bool, device=ids.device)
        for t in range(max_new_tokens):
            logits = model(out)
            tok = sample_token(logits[:, -1], temperature, top_k, top_p,
                               generator)
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id),
                                  tok)
                done = done | (tok == eos_token_id)
            out = torch.cat([out, tok[:, None].to(out.dtype)], dim=1)
            if eos_token_id is not None and t < max_new_tokens - 1 \
                    and bool(done.all()):
                pad = torch.full((b, max_new_tokens - 1 - t), eos_token_id,
                                 dtype=out.dtype, device=out.device)
                out = torch.cat([out, pad], dim=1)
                break
        return out
