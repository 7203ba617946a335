"""Llama family decoder (mirrors ``paddle_tpu/models/llama.py``).

RoPE rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) in float32,
RMSNorm computes in float32, attention is SDPA with native GQA (the flash
forward kernel on CUDA), SwiGLU is two matmuls and silu(gate) * up.
Parameter names equal the JAX package's (``convert.py`` maps them);
``Linear`` weights are stored [out, in].

Training: ``loss(input_ids, labels)`` is the next-token cross entropy,
through the blockwise fused LM-head CE (``nn/fused_ce.py``) with
``fused_head_ce`` (the default), else ``F.cross_entropy`` on the logits;
``flops_per_token(seq_len)`` is 6 N + 12 L d S. ``jit.TrainStep`` with
``lambda m, ids: m.loss(ids, ids)`` trains it.

Dense generation: ``forward(ids, caches=..., position_offset=p)`` with
the contiguous caches of ``init_cache`` ([b, max_s, Hk, D] per layer)
writes the new positions' K/V at ``p`` and attends every cached position
not after the query's in plain PyTorch (the JAX package's
``cached_attention`` is a plain einsum too, no Pallas kernel): float32
logits, masked to -1e30, softmax, P cast to q's dtype, KV heads repeated
for GQA. It returns ``(logits, caches)``; the caches are written in
place (JAX's are new arrays), so a caller keeps one set per sequence.
``generate`` (``models/generation.py``) drives it.

Serving: ``paged_prefill`` runs the dense causal forward over the prompt
padded with token 0 to a block multiple (or to a bucket, ``pad_to``),
writes every padded position's KV into the slot's pool blocks and
samples at ``true_len - 1``; ``paged_prefill_extend`` computes only the
tail a prefix-cache hit leaves uncovered, attending the cached blocks
through ``paged_prefix_attention_dense``; ``paged_decode_step`` writes
each live slot's new KV at ``seq_len`` and attends the paged cache with
``seq_len + 1``. ``paged_spec_step`` (speculative decode) writes
and attends ``1 + k`` positions per slot in one sweep, through
``paged_spec_attention_dense``, and returns every position's greedy
token. With an int8 cache the KV is quantized on its way into
the pools and dequantized by the decode and the tail attention; the
prompt's own attention in a cold prefill uses the exact KV.

``QAT(...).convert`` (``paddle_tpu_torch.quantization``) turns every
projection and the LM head into a ``ConvertedInt8Linear``: the model runs
unchanged, its linear layers through the int8 weight matmul.
``use_fp8`` re-classes the seven projections of every layer (not the LM
head) as ``amp.fp8.FP8Linear``; the paged paths call the same modules, so
serving runs them too, with frozen scales in eval mode. ``QAT`` takes an
``FP8Linear`` as the ``Linear`` it is, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..amp.fp8 import convert_to_fp8
from ..core.device import resolve_device
from ..kernels.flash_attention import scaled_dot_product_attention
from ..nn import Embedding, Linear, RMSNorm
from ..nn import functional as F
from ..nn.fused_ce import fused_linear_cross_entropy
from .generation import sample_token


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = None  # GQA; None = MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_fp8: bool = False  # fp8 projections (amp.fp8 delayed scaling)
    # loss() uses the blockwise fused LM-head CE (nn/fused_ce.py)
    fused_head_ce: bool = True

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def llama3_8b():
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8,
                           max_position_embeddings=8192,
                           rope_theta=500000.0)

    @staticmethod
    def llama3_70b():
        return LlamaConfig(vocab_size=128256, hidden_size=8192,
                           intermediate_size=28672, num_layers=80,
                           num_heads=64, num_kv_heads=8,
                           max_position_embeddings=8192,
                           rope_theta=500000.0)

    @staticmethod
    def tiny():
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_position_embeddings=64)


def apply_rope(q, k, theta=10000.0, position_offset=0):
    """Rotary embedding on [b, s, h, d] tensors over interleaved pairs.
    ``position_offset`` is an int (prefill) or a [b] tensor of per-slot
    offsets (paged decode). Positions and the rotation are float32."""
    b, s, _, d = q.shape
    dev = q.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=dev) / d))
    steps = torch.arange(s, dtype=torch.float32, device=dev)
    if torch.is_tensor(position_offset) and position_offset.dim() == 1:
        pos = position_offset.to(dev, torch.float32)[:, None] + steps
        freqs = pos[..., None] * inv_freq             # [b, s, d/2]
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]
    else:
        pos = float(position_offset) + steps
        freqs = torch.outer(pos, inv_freq)            # [s, d/2]
        cos = torch.cos(freqs)[None, :, None, :]
        sin = torch.sin(freqs)[None, :, None, :]

    def rot(x):
        x1 = x[..., 0::2].float()
        x2 = x[..., 1::2].float()
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = config.head_dim
        self.rope_theta = config.rope_theta
        std = config.initializer_range
        kv_out = self.num_kv_heads * self.head_dim
        self.q_proj = Linear(d, d, std=std, **kw)
        self.k_proj = Linear(d, kv_out, std=std, **kw)
        self.v_proj = Linear(d, kv_out, std=std, **kw)
        self.o_proj = Linear(d, d, std=std, **kw)

    def qkv(self, h, position_offset=0):
        """Projected, rope'd q [b, s, Hq, D] and k/v [b, s, Hk, D]."""
        b, s, _ = h.shape
        q = self.q_proj(h).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(h).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(h).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rope(q, k, theta=self.rope_theta,
                          position_offset=position_offset)
        return q, k, v

    def forward(self, x, cache=None, position_offset=0, kv_sink=None):
        """Causal self-attention over ``x`` [b, s, d]. With ``cache``
        (k_cache, v_cache) [b, max_s, Hk, D]: this block's K/V are written
        at ``position_offset`` (in place) and every cached position not
        after the query's is attended; returns (out, (k_cache,
        v_cache))."""
        b, s, d = x.shape
        q, k, v = self.qkv(x, position_offset=position_offset)
        if kv_sink is not None:  # paged prefill captures post-rope KV
            kv_sink.append((k, v))
        if cache is None:
            out = scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.o_proj(out.reshape(b, s, d))
        k_cache, v_cache = cache
        off = int(position_offset)
        k_cache[:, off:off + s] = k.to(k_cache.dtype)
        v_cache[:, off:off + s] = v.to(v_cache.dtype)
        out = cached_attention(q, k_cache, v_cache, off)
        return self.o_proj(out.reshape(b, s, d)), (k_cache, v_cache)


def cached_attention(q, k_cache, v_cache, position_offset):
    """q [b, s, Hq, D] at positions ``position_offset ..`` against the
    contiguous caches [b, max_s, Hk, D]: float32 logits at 1/sqrt(D),
    cached positions after the query's masked to -1e30, softmax, P cast
    to q's dtype, KV heads repeated for GQA (``paddle_tpu/models/
    llama.py:180-206``). Plain PyTorch, as there."""
    s, max_s = q.shape[1], k_cache.shape[1]
    rep = q.shape[2] // k_cache.shape[2]
    kf = k_cache.repeat_interleave(rep, dim=2) if rep > 1 else k_cache
    vf = v_cache.repeat_interleave(rep, dim=2) if rep > 1 else v_cache
    logits = torch.einsum("bsnd,btnd->bnst", q.float(), kf.float()) \
        * (1.0 / q.shape[-1] ** 0.5)
    pos_q = position_offset + torch.arange(s, device=q.device)
    pos_k = torch.arange(max_s, device=q.device)
    logits = logits.masked_fill(pos_k[None, :] > pos_q[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, vf.to(q.dtype))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        d, i = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        self.gate_proj = Linear(d, i, std=std, **kw)
        self.up_proj = Linear(d, i, std=std, **kw)
        self.down_proj = Linear(i, d, std=std, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 generator=None, requires_grad=False):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator,
                  requires_grad=requires_grad)
        eps = config.rms_norm_eps
        norm_kw = dict(device=device, dtype=dtype,
                       requires_grad=requires_grad)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, **norm_kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                **norm_kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cache=None, position_offset=0, kv_sink=None):
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x), kv_sink=kv_sink)
            return x + self.mlp(self.post_attention_layernorm(x))
        attn_out, new_cache = self.self_attn(
            self.input_layernorm(x), cache=cache,
            position_offset=position_offset)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


class Llama(nn.Module):
    """Llama decoder. Parameters are made on ``device`` (default ``cuda``;
    raises without a GPU) in ``dtype`` (default float32), drawn N(0,
    initializer_range) from ``generator``, which must live on ``device``.
    They are frozen (the serving paths') unless ``requires_grad=True``,
    which training passes."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator=None, requires_grad=False):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or torch.float32
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator,
                  requires_grad=requires_grad)
        std = config.initializer_range
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      std=std, **kw)
        self.layers = nn.ModuleList([LlamaBlock(config, **kw)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype,
                            requires_grad=requires_grad)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, std=std, **kw)
        if config.use_fp8:
            convert_to_fp8(self, exclude=("lm_head",))

    @property
    def device(self):
        return self.embed_tokens.weight.device

    def head(self, x):
        """Logits: the ``lm_head`` module (a converted head runs the int8
        matmul), or the embedding when the weights are tied."""
        if self.lm_head is None:
            return F.linear(x, self.embed_tokens.weight)
        return self.lm_head(x)

    def forward_hidden(self, input_ids, kv_sink=None):
        """Decoder stack output (post final RMSNorm), before the head."""
        x = self.embed_tokens(input_ids)
        for block in self.layers:
            x = block(x, kv_sink=kv_sink)
        return self.norm(x)

    def forward(self, input_ids, caches=None, position_offset=0,
                kv_sink=None):
        """Dense causal forward: ids [b, s] -> logits [b, s, vocab]; with
        ``caches`` (``init_cache``) the tokens sit at ``position_offset
        ..`` and it returns (logits, caches)."""
        if caches is None:
            return self.head(self.forward_hidden(input_ids,
                                                 kv_sink=kv_sink))
        x = self.embed_tokens(input_ids)
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, c = block(x, cache=cache, position_offset=position_offset)
            new_caches.append(c)
        return self.head(self.norm(x)), new_caches

    def init_cache(self, batch_size, max_seq_len, dtype=None):
        """Empty contiguous KV caches: per layer (k, v) of [b, max_s,
        Hk, D] zeros on the model's device, in ``dtype`` (default the
        embedding's)."""
        dt = dtype or self.embed_tokens.weight.dtype
        shape = (batch_size, max_seq_len, self.config.num_kv_heads,
                 self.config.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(self.config.num_layers)]

    def generate(self, input_ids, max_new_tokens=32, **kwargs):
        """``models.generation.generate`` on this model."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        **kwargs)

    # -- training ---------------------------------------------------------

    def loss(self, input_ids, labels):
        """Next-token cross entropy of ``labels`` (aligned with
        ``input_ids``, shifted here). The fused head slices the hidden
        states, not the logits; the head's weight is [vocab, d] whether
        tied (the embedding) or not (a port ``Linear``), so the fused CE
        always takes it transposed."""
        if self.config.fused_head_ce:
            x = self.forward_hidden(input_ids)[:, :-1, :]
            w = self.embed_tokens.weight if self.lm_head is None \
                else self.lm_head.weight
            return fused_linear_cross_entropy(x, w, labels[:, 1:],
                                              transpose_weight=True)
        logits = self(input_ids)
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:])

    def flops_per_token(self, seq_len):
        """Training flops a token (forward + backward): 6 N + 12 L d S."""
        n = self.num_params()
        l, d = self.config.num_layers, self.config.hidden_size
        return 6 * n + 12 * l * d * seq_len

    # -- paged (block) KV-cache serving -----------------------------------

    def _pick(self, last, temperature, generator):
        if temperature > 0:
            return sample_token(last / max(temperature, 1e-6),
                                temperature=1.0, generator=generator)
        return torch.argmax(last, dim=-1)

    @staticmethod
    def _padded_len(cache, n, pad_to):
        """``n`` tokens padded to a block multiple, or to ``pad_to`` (a
        bucket, ``serving/bucketing.py``) clamped to the table's
        ``max_blocks_per_seq * block_size`` and rounded to a block
        multiple."""
        bs = cache.block_size
        spad = -(-n // bs) * bs
        if pad_to is not None:
            want = min(max(int(pad_to), spad),
                       cache.max_blocks_per_seq * bs)
            spad = -(-want // bs) * bs
        return spad

    @torch.inference_mode()
    def paged_prefill(self, cache, slot, prompt_ids, temperature=0.0,
                      generator=None, pad_to=None):
        """Run the prompt, padded with token 0 to a block multiple (or to
        the bucket ``pad_to``), through the dense causal forward; write its
        post-rope KV (padding included) into the slot's pool blocks; set
        seq_len to the true length; return the token sampled from the
        logits at ``true_len - 1``. Padding past the slot's blocks lands
        in null block 0 (the table's entries there are 0) and everything
        past the true length is masked."""
        from ..inference.paged import (paged_prefill_write,
                                       paged_prefill_write_q)

        prompt = np.asarray(prompt_ids).reshape(-1)
        s = prompt.shape[0]
        spad = self._padded_len(cache, s, pad_to)
        ids = np.zeros((1, spad), np.int64)
        ids[:, :s] = prompt
        sink = []
        hidden = self.forward_hidden(
            torch.as_tensor(ids, device=self.device), kv_sink=sink)
        last = self.head(hidden[:, s - 1])
        tok = self._pick(last, temperature, generator)
        row = torch.as_tensor(cache.block_tables[slot], device=self.device)
        for i, (k, v) in enumerate(sink):
            if cache.quantized:
                paged_prefill_write_q(cache.k_pools[i], cache.v_pools[i],
                                      cache.k_scales[i], cache.v_scales[i],
                                      row, k[0], v[0])
            else:
                paged_prefill_write(cache.k_pools[i], cache.v_pools[i], row,
                                    k[0], v[0])
        cache.seq_lens[slot] = s
        return int(tok[0])

    @torch.inference_mode()
    def paged_prefill_extend(self, cache, slot, ids, tail_start, write_start,
                             temperature=0.0, generator=None, pad_to=None):
        """Prefix-cache prefill: the slot's table already maps cached KV
        for positions ``[0, tail_start)``; compute only the tail
        ``ids[tail_start:]`` (padded with token 0 to a block multiple, or
        to the bucket ``pad_to``): embed it, rope at the absolute offset
        ``tail_start``, write its KV at positions ``>= write_start`` only
        (``paged_prefill_write_masked[_q]``; a fully covered prompt
        recomputes its last token and writes nothing), and attend each
        tail token against the slot's whole paged context
        (``paged_prefix_attention_dense``). Sets seq_len to the whole
        length and returns the token sampled at ``total - 1``, as
        ``paged_prefill`` does."""
        from ..inference.paged import (paged_prefill_write_masked,
                                       paged_prefill_write_masked_q,
                                       paged_prefix_attention_dense)

        ids = np.asarray(ids).reshape(-1)
        total = ids.shape[0]
        s_tail = total - tail_start
        spad = self._padded_len(cache, s_tail, pad_to)
        tail = np.zeros((1, spad), np.int64)
        tail[0, :s_tail] = ids[tail_start:]
        dev = self.device
        cfg = self.config
        row = torch.as_tensor(cache.block_tables[slot], device=dev)
        x = self.embed_tokens(torch.as_tensor(tail, device=dev))
        for i, blk in enumerate(self.layers):
            attn = blk.self_attn
            q, k, v = attn.qkv(blk.input_layernorm(x),
                               position_offset=tail_start)
            kp, vp = cache.k_pools[i], cache.v_pools[i]
            if cache.quantized:
                ks, vs = cache.k_scales[i], cache.v_scales[i]
                paged_prefill_write_masked_q(kp, vp, ks, vs, row, k[0], v[0],
                                             tail_start, write_start, total)
            else:
                ks = vs = None
                paged_prefill_write_masked(kp, vp, row, k[0], v[0],
                                           tail_start, write_start, total)
            out = paged_prefix_attention_dense(q[0], kp, vp, row, tail_start,
                                               total, k_scale=ks, v_scale=vs)
            x = x + attn.o_proj(out.reshape(1, spad, cfg.hidden_size))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        last = self.head(self.norm(x[:, total - 1 - tail_start]))
        tok = self._pick(last, temperature, generator)
        cache.seq_lens[slot] = total
        return int(tok[0])

    @torch.inference_mode()
    def paged_decode_step(self, cache, last_tokens, active, temperature=0.0,
                          kernel_mode=None, generator=None):
        """One decode step for every slot: write the incoming token's KV
        at position seq_len (inactive slots write into null block 0, row
        0), attend the paged cache with seq_len + 1 for active slots,
        sample the next token. Pools update in place; seq_lens advance on
        the host. Returns [max_batch] int64 numpy tokens."""
        from ..inference.paged import (paged_decode_attention,
                                       paged_decode_write,
                                       paged_decode_write_q,
                                       resolve_paged_kernel)

        mode = resolve_paged_kernel(kernel_mode)
        dev = self.device
        cfg = self.config
        hq, hd = cfg.num_heads, cfg.head_dim
        toks = torch.as_tensor(np.asarray(last_tokens), device=dev).long()
        lens = torch.as_tensor(cache.seq_lens, device=dev)
        act = torch.as_tensor(np.asarray(active), device=dev)
        tables = torch.as_tensor(cache.block_tables, device=dev)
        attend_lens = torch.where(act, lens + 1, lens).to(torch.int32)
        b = toks.shape[0]
        x = self.embed_tokens(toks[:, None])
        for i, blk in enumerate(self.layers):
            attn = blk.self_attn
            q, k, v = attn.qkv(blk.input_layernorm(x), position_offset=lens)
            if cache.quantized:
                ks, vs = cache.k_scales[i], cache.v_scales[i]
                paged_decode_write_q(cache.k_pools[i], cache.v_pools[i],
                                     ks, vs, tables, lens, k[:, 0], v[:, 0],
                                     act)
            else:
                ks = vs = None
                paged_decode_write(cache.k_pools[i], cache.v_pools[i],
                                   tables, lens, k[:, 0], v[:, 0], act)
            out = paged_decode_attention(q[:, 0], cache.k_pools[i],
                                         cache.v_pools[i], tables,
                                         attend_lens, kernel_mode=mode,
                                         k_scale=ks, v_scale=vs)
            x = x + attn.o_proj(out.reshape(b, 1, hq * hd))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        logits = self.head(self.norm(x))[:, 0]
        nxt = self._pick(logits, temperature, generator)
        act_np = np.asarray(active)
        cache.seq_lens = np.where(act_np, cache.seq_lens + 1,
                                  cache.seq_lens).astype(np.int32)
        return nxt.cpu().numpy()

    @torch.inference_mode()
    def paged_spec_step(self, cache, last_tokens, draft_tokens, n_inputs,
                        active):
        """Speculative verify sweep: write the KV of ``1 + k`` candidate
        tokens per active slot (``last_tokens[b]``, then
        ``draft_tokens[b]``) at positions ``seq_lens[b] ..``, attend each
        against the slot's paged context causally by absolute position
        (``paged_spec_attention_dense``) and return [max_batch, 1 + k]
        int64 numpy greedy tokens: ``out[b, i]`` is the token sequential
        greedy decode would emit after consuming input ``i``.
        ``n_inputs[b]`` (1 + the real drafts) masks padding writes. Pools
        update in place; ``seq_lens`` do not advance: the caller
        (``Scheduler._decode_spec``) accepts the longest matching prefix
        and rolls rejected rows back. Greedy only."""
        from ..inference.paged import (paged_spec_attention_dense,
                                       paged_spec_write, paged_spec_write_q)

        dev = self.device
        cfg = self.config
        toks = np.concatenate([np.asarray(last_tokens).reshape(-1, 1),
                               np.asarray(draft_tokens)], axis=1)
        toks = torch.as_tensor(toks, device=dev).long()
        lens = torch.as_tensor(cache.seq_lens, device=dev)
        n_in = torch.as_tensor(np.asarray(n_inputs), device=dev)
        act = torch.as_tensor(np.asarray(active), device=dev)
        tables = torch.as_tensor(cache.block_tables, device=dev)
        b, s = toks.shape
        x = self.embed_tokens(toks)
        for i, blk in enumerate(self.layers):
            attn = blk.self_attn
            q, k, v = attn.qkv(blk.input_layernorm(x), position_offset=lens)
            kp, vp = cache.k_pools[i], cache.v_pools[i]
            if cache.quantized:
                ks, vs = cache.k_scales[i], cache.v_scales[i]
                paged_spec_write_q(kp, vp, ks, vs, tables, lens, k, v, n_in,
                                   act)
            else:
                ks = vs = None
                paged_spec_write(kp, vp, tables, lens, k, v, n_in, act)
            out = paged_spec_attention_dense(q, kp, vp, tables, lens, act,
                                             k_scale=ks, v_scale=vs)
            x = x + attn.o_proj(out.reshape(b, s, cfg.hidden_size))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        logits = self.head(self.norm(x))
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
