"""Paged (block) KV cache, its prefix cache and continuous batching
(mirrors ``paddle_tpu/inference/paged.py``).

- The KV pool is one tensor per layer ``[num_blocks, block_size, Hk, D]``
  on the device; a per-slot block table ``[max_batch, max_blocks_per_seq]``
  int32 maps token positions to pool blocks. Block 0 is the null block:
  fresh table entries point at it and the length mask hides it.
- ``kv_cache_dtype="int8"`` (``FLAGS_kv_cache_dtype``, read once by the
  engine) stores the pools as int8 with float32 scales
  ``[num_blocks, block_size, Hk]`` beside them, one per (token, kv head)
  row (``quantization.quantize_rows``); the attention dequantizes into
  the compute dtype. Default pool sizing grows by the byte ratio
  (``quant_block_ratio``), as the JAX package's does.
- **The pools are updated in place** (``paged_prefill_write[_q]``,
  ``paged_prefill_write_masked[_q]``, ``paged_decode_write[_q]``,
  ``PagedKVCache._copy_block_rows``), where the JAX package returns new
  arrays from functional ``.at[].set`` updates.
- Block tables, sequence lengths, the free list, the refcounts and the
  prefix index are host state (numpy and Python); they are uploaded as
  small tensors each step.
- **Prefix cache.** Block-aligned prompt chunks are content-hashed
  (``chunk_digests``: a rolling blake2b over int64 token bytes, the
  reference's digests bit for bit); ``plan_prefix`` matches a prompt's
  leading chunks (and a partially filled tail block) against the index,
  ``alloc_slot_cached`` maps the matched blocks read-only (refcount + 1)
  and copies a matched partial block that the prompt writes past
  (copy-on-write), ``commit_prefix`` registers a prefilled slot's chunks.
  ``prepare_append`` copies a shared block before a decode append lands
  in it. Registered blocks whose refcount drops to 0 park in an LRU
  (``_cached_free``) and are evicted only when the free list is empty.
- **Speculative decode.** ``prepare_append_range`` makes every position
  of a verify sweep writable (growth, copy-on-write of each shared block
  it touches; a failure rolls the slot's fresh growth back) and
  ``truncate_blocks`` rolls rejected rows' blocks back.
  ``paged_spec_write[_q]`` writes ``1 + k`` rows per slot and
  ``paged_spec_attention_dense`` attends them causally by absolute
  position; like the tail attention it has no Pallas kernel in the
  reference and stays plain PyTorch.
  ``Llama.paged_prefill_extend`` computes only the uncovered tail
  (``paged_prefill_write_masked``, ``paged_prefix_attention_dense``; the
  latter has no Pallas kernel in the reference and stays plain PyTorch).
- ``paged_decode_attention`` is the routing point of the decode attention
  (``FLAGS_paged_kernel``): ``auto``/``kernel`` launch the CUDA kernels for
  CUDA tensors they take (``decode_kernel_takes``) -- the split-KV kernel
  when the table has at least ``_CHUNK_MIN_PAGES`` pages, the per-page
  kernel below -- and the rest (other head dims or groups, queries or
  pools not bf16) on the CUDA cores' kernel
  (``paged_decode_attention_simt``); CPU tensors take the plain version,
  and ``dense`` forces it. ``decode_route`` decides before any launch,
  and ``ROUTE_COUNTS`` records each decision.

Not ported yet: mesh capacity slices (``num_slices``) and the
tensor-parallel decode attention.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import flags as _flags
from ..core.device import resolve_device
from ..profiler import metrics as _metrics
from ..quantization import quantize_rows
from ..kernels.paged_attention import (_NEG, _gather_kv,
                                       decode_kernel_takes,
                                       paged_decode_attention_chunked,
                                       paged_decode_attention_dense,
                                       paged_decode_attention_kernel,
                                       paged_decode_attention_simt)

__all__ = ["PagedKVCache", "CapacityError", "ContinuousBatchingEngine",
           "PrefixPlan", "chunk_digests",
           "paged_prefill_write", "paged_prefill_write_q",
           "paged_prefill_write_masked", "paged_prefill_write_masked_q",
           "paged_prefix_attention_dense",
           "paged_decode_write", "paged_decode_write_q",
           "paged_decode_attention", "paged_decode_attention_dense",
           "paged_spec_write", "paged_spec_write_q",
           "paged_spec_attention_dense", "kernel_route", "decode_route",
           "validate_request", "sized_num_blocks", "prefill_ids",
           "resolve_paged_kernel",
           "resolve_kv_dtype", "quant_block_ratio", "ROUTE_COUNTS"]

# pool-exhaustion preemptions, under the name the serving scheduler
# counts its own under (both engines report as one metric)
_PREEMPTS = _metrics.counter("serving.preempt")
# prefix-cache economics: blocks mapped from the cache and computed fresh
# at admission, copy-on-write copies, LRU evictions of cold cached blocks
_PREFIX_HITS = _metrics.counter("serving.prefix.hit_blocks")
_PREFIX_MISSES = _metrics.counter("serving.prefix.miss_blocks")
_PREFIX_COW = _metrics.counter("serving.prefix.cow_copies")
_PREFIX_EVICT = _metrics.counter("serving.prefix.evictions")

_KERNEL_MODES = ("auto", "kernel", "dense")
# tables at least this many pages long route to the split-KV kernel
_CHUNK_MIN_PAGES = 16

# decode-attention routing decisions (``decode_route``), one a call:
# ``kernel`` (the per-page kernel) or ``split`` (the split-KV kernel) for
# CUDA tensors those kernels take; ``simt`` (the CUDA cores' kernel) for
# the other CUDA tensors; ``plain`` for CPU tensors (the plain version);
# ``dense`` when FLAGS_paged_kernel=dense forces the plain version. The
# kernels' own ``launches`` counts move only on CUDA launches.
ROUTE_COUNTS = {"kernel": 0, "split": 0, "simt": 0, "plain": 0,
                "dense": 0}


def resolve_paged_kernel(mode=None):
    """Normalize a routing mode (a ctor kwarg or ``FLAGS_paged_kernel``):
    ``auto`` | ``kernel`` | ``dense``."""
    if mode is None:
        mode = _flags.flag("FLAGS_paged_kernel")
    m = str(mode or "auto").strip().lower()
    if m not in _KERNEL_MODES:
        raise ValueError(f"FLAGS_paged_kernel must be one of "
                         f"{_KERNEL_MODES}, got {mode!r}")
    return m


def kernel_route(mode, device):
    """Where a resolved mode's decode attention runs on ``device``, for
    the ``serving.decode_step`` span: ``"cuda"`` (the CUDA kernels) or
    ``"dense"`` (the plain version: forced, or CPU tensors), as the
    reference names its own ``"pallas"`` and ``"dense"`` routes."""
    if resolve_paged_kernel(mode) == "dense" or \
            torch.device(device).type != "cuda":
        return "dense"
    return "cuda"


def resolve_kv_dtype(kv_cache_dtype):
    """Normalize ``kv_cache_dtype`` (a ctor kwarg or
    ``FLAGS_kv_cache_dtype``): ``None`` for pools in the compute dtype,
    ``"int8"`` for quantized pools; anything else raises."""
    v = str(kv_cache_dtype or "").strip().lower()
    if v in ("", "none", "auto", "0", "off", "false"):
        return None
    if v == "int8":
        return "int8"
    raise ValueError(f"kv_cache_dtype: unsupported value {kv_cache_dtype!r} "
                     f"(expected '' or 'int8')")


def quant_block_ratio(head_dim, dtype):
    """Bytes per block of a ``dtype`` pool over an int8 pool with its
    float32 scales: each head-row costs ``head_dim * itemsize`` bytes
    against ``head_dim + 4``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return head_dim * itemsize / (head_dim + 4)


# ---------------------------------------------------------------------------
# content addressing (prefix cache)
# ---------------------------------------------------------------------------

def chunk_digests(token_ids, block_size):
    """Rolling content hashes of the full block-aligned chunks of
    ``token_ids`` (as int64; hash real tokens only, never bucket
    padding). Each digest folds in its parent's, so a chunk's digest
    names the whole prefix up to and including that chunk."""
    ids = np.ascontiguousarray(np.asarray(token_ids).reshape(-1),
                               dtype=np.int64)
    out, parent = [], b""
    for c in range(ids.size // block_size):
        parent = hashlib.blake2b(
            parent + ids[c * block_size:(c + 1) * block_size].tobytes(),
            digest_size=16).digest()
        out.append(parent)
    return out


def _partial_key(parent_digest, token_ids):
    """Content key of a partially filled tail block: the full-chunk
    parent chain plus the partial tokens themselves."""
    ids = np.ascontiguousarray(np.asarray(token_ids).reshape(-1),
                               dtype=np.int64)
    return hashlib.blake2b(parent_digest + b"|part|" + ids.tobytes(),
                           digest_size=16).digest()


class CapacityError:
    """Falsy result of a failed ``ensure_capacity``/``prepare_append``:
    ``blocks`` (pool exhausted; eviction or preemption can help) or
    ``seq_limit`` (the sequence outgrew ``max_blocks_per_seq``; it can
    never fit)."""

    __slots__ = ("reason", "detail")

    BLOCKS = "blocks"
    SEQ_LIMIT = "seq_limit"

    def __init__(self, reason, detail=""):
        self.reason = reason
        self.detail = detail

    def __bool__(self):
        return False

    def __repr__(self):
        return f"CapacityError({self.reason!r}, {self.detail!r})"


@dataclass
class PrefixPlan:
    """Admission plan from ``PagedKVCache.plan_prefix``: which leading
    chunks of a prompt are resident (and where), and how much of the
    prompt they cover. Computing a plan has no side effects;
    ``alloc_slot_cached`` consumes it."""

    ids: np.ndarray            # the (unpadded) token ids planned against
    num_tokens: int
    chunks_total: int          # ceil(num_tokens / block_size), >= 1
    digests: list              # rolling digests of the full chunks
    matched_full: int          # leading full chunks found in the index
    matched_blocks: list       # their pool block ids, in chunk order
    partial_block: int | None  # matched partially filled tail block
    partial_len: int           # tokens matched inside it
    partial_shared: bool       # True: mapped read-only (no write lands in
    #                            it); False: copied at admission
    covered_tokens: int        # matched_full * block_size + partial_len

    @property
    def tail_start(self):
        """First position the prefill must compute. Full coverage still
        recomputes the last token: its logits seed decoding."""
        return self.covered_tokens if self.covered_tokens \
            < self.num_tokens else self.num_tokens - 1

    @property
    def write_start(self):
        """First position the prefill may write (never a shared row;
        full coverage writes nothing)."""
        return self.covered_tokens

    @property
    def hit_blocks(self):
        return self.matched_full + (1 if self.partial_block is not None
                                    else 0)


class PagedKVCache:
    """Per-layer block pools (device) + block tables, sequence lengths,
    free list, per-block refcounts and the prefix index (host).

    A block registered in the prefix index is immutable in its
    registered rows and may back several slots (refcount > 1). Appends
    past every sharer's length are safe in place at refcount 1; a write
    into a block with refcount > 1 copies it first (``prepare_append``,
    admission copy-on-write). ``free_slot`` only decrements refcounts:
    registered blocks that reach 0 park in an LRU of reclaimable blocks,
    which allocation evicts before it fails. A cache whose chunks are
    never registered (``commit_prefix``) behaves as one without the
    prefix cache."""

    def __init__(self, num_layers, num_kv_heads, head_dim, *, num_blocks,
                 block_size=16, max_blocks_per_seq, max_batch,
                 dtype=torch.bfloat16, kv_dtype=None, device=None):
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_batch = max_batch
        self.dtype = dtype  # the compute dtype int8 rows dequantize into
        self.device = resolve_device(device)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.quantized = self.kv_dtype == "int8"
        store = torch.int8 if self.quantized else dtype

        def pools(shape, dt):
            return [torch.zeros(shape, dtype=dt, device=self.device)
                    for _ in range(num_layers)]

        shape = (num_blocks, block_size, num_kv_heads, head_dim)
        self.k_pools = pools(shape, store)
        self.v_pools = pools(shape, store)
        if self.quantized:
            self.k_scales = pools(shape[:3], torch.float32)
            self.v_scales = pools(shape[:3], torch.float32)
        else:
            self.k_scales = self.v_scales = None
        # block 0 is the null block; pop() hands out block 1 first
        self._free = list(range(num_blocks - 1, 0, -1))
        self.block_tables = np.zeros((max_batch, max_blocks_per_seq),
                                     np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self._slot_blocks = [[] for _ in range(max_batch)]
        self._live = [False] * max_batch
        # prefix-cache state (inert until commit_prefix registers chunks)
        self._refcount = np.zeros((num_blocks,), np.int32)
        self._prefix_index = {}    # full-chunk digest -> block id
        self._partial_index = {}   # partial-tail key  -> block id
        self._block_keys = {}      # block id -> [(kind, key), ...]
        self._cached_free = OrderedDict()  # refcount-0 registered, LRU

    # -- occupancy ---------------------------------------------------------

    def free_slots(self):
        return [i for i, live in enumerate(self._live) if not live]

    def num_free_blocks(self):
        """Blocks allocatable now: free plus reclaimable cached ones."""
        return len(self._free) + len(self._cached_free)

    def num_cached_blocks(self):
        """Reclaimable refcount-0 blocks held only by the prefix index."""
        return len(self._cached_free)

    def num_shared_blocks(self):
        """Blocks backing more than one slot."""
        return int((self._refcount > 1).sum())

    def reclaimable_blocks(self, slot):
        """How many of the slot's blocks freeing it would return to the
        pool (refcount 1: not shared)."""
        return sum(1 for b in self._slot_blocks[slot]
                   if self._refcount[b] == 1)

    def occupancy(self):
        """Pool occupancy from host state: ``active`` blocks are pinned by
        live slots, ``shared`` of those back more than one slot,
        ``cached_free`` are reclaimable, ``free`` are free; active +
        cached_free + free == usable."""
        usable = self.num_blocks - 1
        free = len(self._free)
        cached = len(self._cached_free)
        return {"usable": usable, "active": usable - free - cached,
                "shared": self.num_shared_blocks(),
                "cached_free": cached, "free": free}

    def pool_bytes(self):
        """Device bytes of the K and V pools (fixed at construction);
        int8 pools count their float32 scale rows too."""
        item = 1 if self.quantized else \
            torch.empty((), dtype=self.dtype).element_size()
        rows = self.num_blocks * self.block_size * self.num_kv_heads
        total = 2 * self.num_layers * rows * self.head_dim * item
        if self.quantized:
            total += 2 * self.num_layers * rows * 4
        return total

    # -- block primitives --------------------------------------------------

    def _drop_cached(self, b):
        """Evict one reclaimable cached block: its index entries go."""
        del self._cached_free[b]
        for kind, key in self._block_keys.pop(b, ()):
            idx = self._prefix_index if kind == "full" \
                else self._partial_index
            if idx.get(key) == b:
                del idx[key]
        _PREFIX_EVICT.inc()

    def _take_block(self):
        """Allocate one block (refcount 1): the free list first, then the
        LRU-oldest cached block. None when both are empty."""
        if self._free:
            b = self._free.pop()
        elif self._cached_free:
            b = next(iter(self._cached_free))
            self._drop_cached(b)
        else:
            return None
        self._refcount[b] = 1
        return b

    def _release_block(self, b):
        """A block's refcount reached 0: park it cached if the index
        still names it, else free it."""
        if self._block_keys.get(b):
            self._cached_free[b] = None  # most-recently-used end
        else:
            self._free.append(b)

    def _ref_block(self, b):
        self._refcount[b] += 1
        if b in self._cached_free:
            del self._cached_free[b]

    def _deref_block(self, b):
        self._refcount[b] -= 1
        if self._refcount[b] <= 0:
            self._refcount[b] = 0
            self._release_block(b)

    def _copy_block_rows(self, src, dst):
        """Copy-on-write body: duplicate one pool block in every layer,
        in place on the device (K and V; int8 pools copy their scale
        rows too, so the copy is bit-exact)."""
        pools = [self.k_pools, self.v_pools]
        if self.quantized:
            pools += [self.k_scales, self.v_scales]
        for per_layer in pools:
            for pool in per_layer:
                pool[dst] = pool[src]

    def alloc_slot(self, num_tokens):
        """Claim the first free slot and enough blocks for ``num_tokens``;
        None if out of slots or blocks."""
        need = max(1, math.ceil(num_tokens / self.block_size))
        free = self.free_slots()
        if not free or need > self.max_blocks_per_seq or \
                need > self.num_free_blocks():
            return None
        slot = free[0]
        blocks = [self._take_block() for _ in range(need)]
        self._slot_blocks[slot] = blocks
        self._live[slot] = True
        self.block_tables[slot] = 0
        self.block_tables[slot, :need] = blocks
        self.seq_lens[slot] = 0
        return slot

    def ensure_capacity(self, slot, new_len):
        """Grow the slot's table so ``new_len`` tokens fit (evicting cold
        cached blocks when the free list is dry). Returns True or a falsy
        :class:`CapacityError`."""
        have = len(self._slot_blocks[slot])
        need = math.ceil(new_len / self.block_size)
        while have < need:
            if have >= self.max_blocks_per_seq:
                return CapacityError(
                    CapacityError.SEQ_LIMIT,
                    f"{new_len} tokens need {need} blocks > "
                    f"max_blocks_per_seq {self.max_blocks_per_seq}")
            b = self._take_block()
            if b is None:
                return CapacityError(
                    CapacityError.BLOCKS,
                    f"pool exhausted growing slot {slot} to {new_len} "
                    f"tokens")
            self.block_tables[slot, have] = b
            self._slot_blocks[slot].append(b)
            have += 1
        return True

    def prepare_append(self, slot, new_len):
        """Make position ``new_len - 1`` writable for this slot: grow the
        table if the position opens a new block, and copy the target
        block first if it is shared (another sharer must never see the
        append). Returns True or a falsy :class:`CapacityError`."""
        r = self.ensure_capacity(slot, new_len)
        if not r:
            return r
        return self._own_block(slot, (new_len - 1) // self.block_size)

    def _own_block(self, slot, ci, why=""):
        """Copy-on-write: if the slot's block ``ci`` is shared, give the
        slot a copy of it. True, or a falsy :class:`CapacityError` when no
        block is left for the copy."""
        b = self._slot_blocks[slot][ci]
        if self._refcount[b] <= 1:
            return True
        nb = self._take_block()
        if nb is None:
            return CapacityError(
                CapacityError.BLOCKS,
                f"pool exhausted copy-on-writing shared block {b}{why}")
        self._copy_block_rows(b, nb)
        self._slot_blocks[slot][ci] = nb
        self.block_tables[slot, ci] = nb
        self._deref_block(b)
        _PREFIX_COW.inc()
        return True

    def prepare_append_range(self, slot, new_len):
        """Speculative form of :meth:`prepare_append`: make every
        position in ``[seq_len, new_len)`` writable: grow the table to
        ``ceil(new_len / block_size)`` blocks and copy each shared block
        the range touches (a draft row must never land in a block
        another slot reads). Returns True or a falsy
        :class:`CapacityError`; on failure the slot's fresh growth is
        rolled back (completed copies stay: they hold the same rows, and
        the plain decode path would copy them anyway)."""
        have0 = len(self._slot_blocks[slot])
        r = self.ensure_capacity(slot, new_len)
        if not r:
            self.truncate_blocks(slot, have0)
            return r
        lo = int(self.seq_lens[slot]) // self.block_size
        hi = (new_len - 1) // self.block_size
        for ci in range(lo, hi + 1):
            r = self._own_block(slot, ci, " for speculative range")
            if not r:
                self.truncate_blocks(slot, have0)
                return r
        return True

    def truncate_blocks(self, slot, keep):
        """Roll the slot's table back to its first ``keep`` blocks (the
        speculative reject path): private blocks return to the free
        list, registered ones park reclaimable. Rows written into kept
        blocks past ``seq_lens`` need no scrub: every reader masks by
        length and the next append overwrites them."""
        blocks = self._slot_blocks[slot]
        if keep >= len(blocks):
            return
        for b in reversed(blocks[keep:]):
            self._deref_block(b)
        del blocks[keep:]
        self.block_tables[slot, keep:] = 0

    def free_slot(self, slot):
        for b in reversed(self._slot_blocks[slot]):
            self._deref_block(b)
        self._slot_blocks[slot] = []
        self._live[slot] = False
        self.block_tables[slot] = 0
        self.seq_lens[slot] = 0

    # -- prefix cache ------------------------------------------------------

    def plan_prefix(self, token_ids):
        """Match a prompt against the prefix index (no side effects): the
        longest run of leading full chunks whose digests are resident,
        then a registered partially filled block whose tokens
        prefix-match the remainder. That block is mapped read-only when it
        completes the prompt exactly (``partial_shared``), else copied at
        admission."""
        ids = np.asarray(token_ids).reshape(-1)
        n = int(ids.size)
        bs = self.block_size
        digests = chunk_digests(ids, bs)
        matched, blocks = 0, []
        for d in digests:
            b = self._prefix_index.get(d)
            if b is None:
                break
            blocks.append(b)
            matched += 1
        covered = matched * bs
        partial_block, partial_len, partial_shared = None, 0, False
        if covered < n:
            parent = digests[matched - 1] if matched else b""
            rem = n - covered
            for p in range(min(bs - 1, rem), 0, -1):
                b = self._partial_index.get(
                    _partial_key(parent, ids[covered:covered + p]))
                if b is not None:
                    partial_block, partial_len = b, p
                    partial_shared = (p == rem)
                    covered += p
                    break
        return PrefixPlan(
            ids=ids, num_tokens=n,
            chunks_total=max(1, math.ceil(n / bs)),
            digests=digests, matched_full=matched,
            matched_blocks=blocks, partial_block=partial_block,
            partial_len=partial_len, partial_shared=partial_shared,
            covered_tokens=covered)

    def alloc_slot_cached(self, plan):
        """Claim a slot for a planned prompt: matched blocks are mapped
        read-only (refcount + 1), a matched partial block the prompt
        writes past is copied, and only the uncovered chunks take fresh
        blocks. Returns the slot or None (the cache is then unchanged)."""
        free = self.free_slots()
        if not free or plan.chunks_total > self.max_blocks_per_seq:
            return None
        slot = free[0]
        shared = list(plan.matched_blocks)
        cow_src = None
        if plan.partial_block is not None:
            if plan.partial_shared:
                shared.append(plan.partial_block)
            else:
                cow_src = plan.partial_block
        # pin every block read before an eviction can run
        for b in shared:
            self._ref_block(b)
        if cow_src is not None:
            self._ref_block(cow_src)
        fresh_needed = plan.chunks_total - len(shared)
        if fresh_needed > self.num_free_blocks():
            if cow_src is not None:
                self._deref_block(cow_src)
            for b in reversed(shared):
                self._deref_block(b)
            return None
        fresh = [self._take_block() for _ in range(fresh_needed)]
        if cow_src is not None:
            self._copy_block_rows(cow_src, fresh[0])
            self._deref_block(cow_src)
            _PREFIX_COW.inc()
        blocks = shared + fresh
        self._slot_blocks[slot] = blocks
        self._live[slot] = True
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(blocks)] = blocks
        self.seq_lens[slot] = 0
        # a copied partial match counts as a hit: its tokens were served
        # from the cache
        hit = plan.hit_blocks
        _PREFIX_HITS.inc(hit)
        _PREFIX_MISSES.inc(plan.chunks_total - hit)
        return slot

    def commit_prefix(self, slot, plan):
        """Register the slot's freshly prefilled chunks in the index
        (their rows are immutable from here on). The first registration
        of a digest wins."""
        blocks = self._slot_blocks[slot]
        for i in range(plan.matched_full, len(plan.digests)):
            d = plan.digests[i]
            if d in self._prefix_index:
                continue
            b = blocks[i]
            self._prefix_index[d] = b
            self._block_keys.setdefault(b, []).append(("full", d))
        rem = plan.num_tokens - len(plan.digests) * self.block_size
        if rem > 0 and not plan.partial_shared:
            parent = plan.digests[-1] if plan.digests else b""
            key = _partial_key(parent, plan.ids[plan.num_tokens - rem:])
            if key not in self._partial_index:
                b = blocks[len(plan.digests)]
                self._partial_index[key] = b
                self._block_keys.setdefault(b, []).append(("part", key))


# ---------------------------------------------------------------------------
# device-side ops (in place)
# ---------------------------------------------------------------------------

def paged_prefill_write(k_pool, v_pool, block_row, k_new, v_new):
    """Write a prompt's KV [S, Hk, D] (S a block multiple) into the pool
    blocks listed first in ``block_row``, in place."""
    s = k_new.shape[0]
    bs = k_pool.shape[1]
    nb = s // bs
    blocks = block_row[:nb].long()
    k_pool[blocks] = k_new.reshape(nb, bs, *k_new.shape[1:]).to(k_pool.dtype)
    v_pool[blocks] = v_new.reshape(nb, bs, *v_new.shape[1:]).to(v_pool.dtype)


def paged_prefill_write_q(k_pool, v_pool, k_scale, v_scale, block_row,
                          k_new, v_new):
    """Quantized :func:`paged_prefill_write`: rows quantize per (position,
    kv head) (``quantize_rows``) before landing; their scales land in the
    scale pools. In place."""
    s = k_new.shape[0]
    bs = k_pool.shape[1]
    nb = s // bs
    blocks = block_row[:nb].long()
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        q, sc = quantize_rows(new)
        pool[blocks] = q.reshape(nb, bs, *q.shape[1:])
        scales[blocks] = sc.reshape(nb, bs, -1)


def _masked_rows(block_row, n, start, write_start, total_len, bs):
    """Validity and (block, offset) of rows ``start .. start + n - 1``:
    rows outside ``[write_start, total_len)`` map to null block 0, row
    0."""
    pos = start + torch.arange(n, device=block_row.device)
    valid = (pos >= write_start) & (pos < total_len)
    zero = torch.zeros_like(pos)
    blocks = torch.where(valid, block_row.long()[torch.where(
        valid, pos // bs, zero)], zero)
    return valid, blocks, torch.where(valid, pos % bs, zero)


def paged_prefill_write_masked(k_pool, v_pool, block_row, k_new, v_new,
                               start, write_start, total_len):
    """Write a prefill tail's KV in place: ``k_new``/``v_new`` [S, Hk, D]
    hold positions ``start .. start + S - 1``; only positions in
    ``[write_start, total_len)`` land. Shared prefix rows and bucket
    padding go to null block 0, row 0, with its old value: nothing else
    changes."""
    valid, blocks, offs = _masked_rows(block_row, k_new.shape[0], start,
                                       write_start, total_len,
                                       k_pool.shape[1])
    keep = valid[:, None, None]
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        pool[blocks, offs] = torch.where(keep, new.to(pool.dtype),
                                         pool[blocks, offs])


def paged_prefill_write_masked_q(k_pool, v_pool, k_scale, v_scale,
                                 block_row, k_new, v_new, start,
                                 write_start, total_len):
    """Quantized :func:`paged_prefill_write_masked`: the same masking,
    rows quantized per (position, kv head) on the way in, their scales
    into the scale pools. In place."""
    valid, blocks, offs = _masked_rows(block_row, k_new.shape[0], start,
                                       write_start, total_len,
                                       k_pool.shape[1])
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        q, sc = quantize_rows(new)
        pool[blocks, offs] = torch.where(valid[:, None, None], q,
                                         pool[blocks, offs])
        scales[blocks, offs] = torch.where(valid[:, None], sc,
                                           scales[blocks, offs])


def paged_prefix_attention_dense(q, k_pool, v_pool, block_row, q_start,
                                 total_len, scale=None, k_scale=None,
                                 v_scale=None):
    """Attention of a prefix-cache tail: queries [S, Hq, D] at absolute
    positions ``q_start .. q_start + S - 1`` attend the slot's whole paged
    context (cached prefix blocks and the tail just written), causal by
    absolute position and masked to ``total_len``. Gather then attend,
    group-folded GQA, float32 logits, a -1e30 mask, probabilities cast to
    V's dtype before P @ V (int8 pools dequantized in the gather). Padded
    query rows give junk that the caller never reads."""
    s, hq, d = q.shape
    _, bs, hk, _ = k_pool.shape
    g = hq // hk
    s_max = block_row.shape[0] * bs
    idx = block_row.long()
    k = _gather_kv(k_pool, idx, k_scale, q.dtype).reshape(s_max, hk, d)
    v = _gather_kv(v_pool, idx, v_scale, q.dtype).reshape(s_max, hk, d)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(s, hk, g, d)
    logits = torch.einsum("sngd,tnd->sngt", qg.float(), k.float()) \
        * sm_scale
    pos_q = q_start + torch.arange(s, device=q.device)
    pos_k = torch.arange(s_max, device=q.device)
    mask = ((pos_k[None, :] <= pos_q[:, None])
            & (pos_k[None, :] < total_len))[:, None, None, :]
    logits = logits.masked_fill(~mask, _NEG)
    probs = torch.softmax(logits, dim=-1) * mask
    out = torch.einsum("sngt,tnd->sngd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(s, hq, d).to(q.dtype)


def _decode_rows(block_tables, positions, active, bs):
    """(block, offset) of each slot's new row; inactive slots get null
    block 0, row 0."""
    pos = positions.long()
    rows = torch.arange(block_tables.shape[0], device=pos.device)
    zero = torch.zeros_like(pos)
    blocks = torch.where(active, block_tables[rows, pos // bs].long(), zero)
    return blocks, torch.where(active, pos % bs, zero)


def paged_decode_write(k_pool, v_pool, block_tables, positions, k_new,
                       v_new, active):
    """Scatter one new token's KV per slot, in place: k_new/v_new
    [B, Hk, D] at ``positions`` [B]. Inactive slots write their old value
    back into null block 0, row 0."""
    blocks, offs = _decode_rows(block_tables, positions, active,
                                k_pool.shape[1])
    keep = active[:, None, None]
    k_pool[blocks, offs] = torch.where(keep, k_new.to(k_pool.dtype),
                                       k_pool[blocks, offs])
    v_pool[blocks, offs] = torch.where(keep, v_new.to(v_pool.dtype),
                                       v_pool[blocks, offs])


def paged_decode_write_q(k_pool, v_pool, k_scale, v_scale, block_tables,
                         positions, k_new, v_new, active):
    """Quantized :func:`paged_decode_write`: one int8 row and one scale per
    (slot, kv head); inactive slots write their old row and scales back
    into null block 0, row 0. In place."""
    blocks, offs = _decode_rows(block_tables, positions, active,
                                k_pool.shape[1])
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        q, sc = quantize_rows(new)
        pool[blocks, offs] = torch.where(active[:, None, None], q,
                                         pool[blocks, offs])
        scales[blocks, offs] = torch.where(active[:, None], sc,
                                           scales[blocks, offs])


def _spec_rows(block_tables, start_lens, n_inputs, active, s, bs):
    """Validity and (block, offset) of each slot's ``s`` sweep rows at
    ``start_lens[b] + i``: rows past ``n_inputs[b]`` and inactive slots
    map to null block 0, row 0. Flattened to ``[B * s]``."""
    steps = torch.arange(s, device=start_lens.device)
    pos = start_lens.long()[:, None] + steps[None, :]
    valid = active[:, None] & (steps[None, :] < n_inputs.long()[:, None])
    zero = torch.zeros_like(pos)
    rows = torch.arange(block_tables.shape[0], device=pos.device)[:, None]
    blocks = torch.where(valid, block_tables[rows, torch.where(
        valid, pos // bs, zero)].long(), zero)
    offs = torch.where(valid, pos % bs, zero)
    return valid.reshape(-1), blocks.reshape(-1), offs.reshape(-1)


def paged_spec_write(k_pool, v_pool, block_tables, start_lens, k_new,
                     v_new, n_inputs, active):
    """Scatter a verify sweep's KV in place: ``k_new``/``v_new``
    [B, S, Hk, D] land at positions ``start_lens[b] + i``. Only the first
    ``n_inputs[b]`` rows of an active slot are real; the rest (draft
    padding, inactive slots) write null block 0's old value back."""
    b, s = k_new.shape[:2]
    valid, blocks, offs = _spec_rows(block_tables, start_lens, n_inputs,
                                     active, s, k_pool.shape[1])
    keep = valid[:, None, None]
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = new.reshape(b * s, *new.shape[2:]).to(pool.dtype)
        pool[blocks, offs] = torch.where(keep, flat, pool[blocks, offs])


def paged_spec_write_q(k_pool, v_pool, k_scale, v_scale, block_tables,
                       start_lens, k_new, v_new, n_inputs, active):
    """Quantized :func:`paged_spec_write`: rows quantize per (position,
    kv head) (``quantize_rows``) on the way in, their scales into the
    scale pools; masked rows keep null block 0's old row and scales. In
    place."""
    b, s = k_new.shape[:2]
    valid, blocks, offs = _spec_rows(block_tables, start_lens, n_inputs,
                                     active, s, k_pool.shape[1])
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        q, sc = quantize_rows(new.reshape(b * s, *new.shape[2:]))
        pool[blocks, offs] = torch.where(valid[:, None, None], q,
                                         pool[blocks, offs])
        scales[blocks, offs] = torch.where(valid[:, None], sc,
                                           scales[blocks, offs])


def paged_spec_attention_dense(q, k_pool, v_pool, block_tables, start_lens,
                               active, scale=None, k_scale=None,
                               v_scale=None):
    """Attention of a verify sweep: queries [B, S, Hq, D] at absolute
    positions ``start_lens[b] + i`` attend each slot's whole paged
    context causally by absolute position (``pos_k <= pos_q``), so query
    ``i`` sees exactly the keys a sequential decode step there would.
    Gather then attend, group-folded GQA, float32 logits, a -1e30 mask,
    probabilities cast to V's dtype before P @ V (int8 pools dequantized
    and rounded to q's dtype in the gather). Inactive slots give zeros;
    padded draft rows give junk the caller never reads."""
    b, s, hq, d = q.shape
    _, bs, hk, _ = k_pool.shape
    g = hq // hk
    s_max = block_tables.shape[1] * bs
    idx = block_tables.long()
    k = _gather_kv(k_pool, idx, k_scale, q.dtype).reshape(b, s_max, hk, d)
    v = _gather_kv(v_pool, idx, v_scale, q.dtype).reshape(b, s_max, hk, d)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hk, g, d)
    logits = torch.einsum("bsngd,btnd->bsngt", qg.float(), k.float()) \
        * sm_scale
    pos_q = start_lens.long()[:, None] + torch.arange(s, device=q.device)
    pos_k = torch.arange(s_max, device=q.device)
    mask = ((pos_k[None, None, :] <= pos_q[:, :, None])
            & active[:, None, None])[:, :, None, None, :]
    logits = logits.masked_fill(~mask, _NEG)
    probs = torch.softmax(logits, dim=-1) * mask
    out = torch.einsum("bsngt,btnd->bsngd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens,
                           kernel_mode=None, k_scale=None, v_scale=None):
    """Masked decode attention over the paged cache; q [B, Hq, D] ->
    [B, Hq, D]. Int8 pools pass their ``k_scale``/``v_scale``. See the
    module docstring for the routes."""
    route = decode_route(resolve_paged_kernel(kernel_mode), q.device.type,
                         decode_kernel_takes(q, k_pool, v_pool, k_scale),
                         block_tables.shape[1])
    ROUTE_COUNTS[route] += 1
    args = (q, k_pool, v_pool, block_tables, seq_lens, k_scale, v_scale)
    if route == "split":
        return paged_decode_attention_chunked(*args)
    if route == "kernel":
        return paged_decode_attention_kernel(*args)
    if route == "simt":
        return paged_decode_attention_simt(*args)
    return paged_decode_attention_dense(*args)


def decode_route(mode, device_type, takes, pages):
    """The decode attention's route from a resolved mode, the tensors'
    device type, whether the kernels take their dtypes and shapes
    (``decode_kernel_takes``) and the table's pages: ``dense`` (forced),
    ``plain`` (CPU tensors), ``simt`` (CUDA tensors those kernels do not
    take), ``split`` (at least ``_CHUNK_MIN_PAGES`` pages) or ``kernel``.
    Pure: decided before any launch."""
    if mode == "dense":
        return "dense"
    if device_type == "cpu":
        return "plain"
    if not takes:
        return "simt"
    return "split" if pages >= _CHUNK_MIN_PAGES else "kernel"


# ---------------------------------------------------------------------------
# continuous batching engine
# ---------------------------------------------------------------------------

def validate_request(prompt_ids, max_new_tokens, max_seq_len, cache,
                     who="add_request"):
    """Submit-time checks: non-empty prompt, >= 1 new token, prompt and
    prompt + max_new within ``max_seq_len``, worst-case block demand within
    the pool. Returns the flattened prompt array."""
    prompt = np.asarray(prompt_ids).reshape(-1)
    if prompt.size == 0:
        raise ValueError(f"{who}: empty prompt")
    if max_new_tokens < 1:
        raise ValueError(f"{who}: max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if prompt.size > max_seq_len:
        raise ValueError(f"{who}: prompt length {prompt.size} exceeds "
                         f"max_seq_len {max_seq_len}")
    if prompt.size + max_new_tokens > max_seq_len:
        raise ValueError(
            f"{who}: prompt ({prompt.size}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_seq_len {max_seq_len}")
    need = math.ceil((prompt.size + max_new_tokens - 1) / cache.block_size)
    usable = cache.num_blocks - 1
    if need > usable:
        raise ValueError(
            f"{who}: request needs up to {need} KV blocks but the pool "
            f"has only {usable} usable; increase num_blocks or lower "
            "max_new_tokens")
    return prompt


def sized_num_blocks(num_blocks, max_batch, max_blocks_per_seq, kv_dtype,
                     head_dim, dtype):
    """``max_batch * max_blocks_per_seq`` blocks plus the null block, or
    :func:`quant_block_ratio` times as many for int8 pools (the same
    bytes), unless ``num_blocks`` is given. Equal to the JAX package's
    sizing, so that both engines preempt at the same step."""
    if num_blocks is not None:
        return num_blocks
    base = max_batch * max_blocks_per_seq
    if kv_dtype == "int8":
        base = int(base * quant_block_ratio(head_dim, dtype))
    return base + 1


def prefill_ids(req):
    """A request's prompt plus any already-generated tokens: the
    re-prefill after a preemption continues the sequence where it
    stopped, its sampled token being the next new one."""
    if not req.generated:
        return req.prompt
    return np.concatenate(
        [req.prompt, np.asarray(req.generated, dtype=req.prompt.dtype)])


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: list = field(default_factory=list)
    slot: int = -1


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a paged cache.

    ``add_request()`` enqueues prompts; ``step()`` admits waiting prompts
    into free slots (prefill) and decodes one token for every live slot;
    finished sequences release their blocks at once. When the pool runs
    dry a live request is preempted: it loses its blocks and re-prefills
    prompt + generated tokens later, so greedy output is unchanged.
    The cache lives on the model's device.
    """

    def __init__(self, model, *, max_batch=8, block_size=16,
                 max_seq_len=2048, num_blocks=None, temperature=0.0,
                 eos_token_id=None, dtype=torch.bfloat16,
                 kv_cache_dtype=None, generator=None):
        cfg = model.config
        self.model = model
        self.eos_token_id = eos_token_id
        self.temperature = temperature
        self.max_seq_len = max_seq_len
        self.generator = generator
        if kv_cache_dtype is None:
            kv_cache_dtype = _flags.flag("FLAGS_kv_cache_dtype")
        kv_dtype = resolve_kv_dtype(kv_cache_dtype)
        self.kernel_mode = resolve_paged_kernel(None)
        mbps = math.ceil(max_seq_len / block_size)
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            num_blocks=sized_num_blocks(num_blocks, max_batch, mbps,
                                        kv_dtype, cfg.head_dim, dtype),
            block_size=block_size, max_blocks_per_seq=mbps,
            max_batch=max_batch, dtype=dtype, kv_dtype=kv_dtype,
            device=model.device)
        self.waiting: list[_Request] = []
        self.running: dict[int, _Request] = {}  # slot -> request
        self.finished: dict[int, _Request] = {}
        self.preemptions = 0
        self._next_rid = 0
        self._last_tok = np.zeros((max_batch,), np.int64)
        self._remaining = np.zeros((max_batch,), np.int64)

    def add_request(self, prompt_ids, max_new_tokens=32):
        prompt = validate_request(prompt_ids, max_new_tokens,
                                  self.max_seq_len, self.cache)
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(_Request(rid, prompt, max_new_tokens))
        return rid

    @property
    def has_work(self):
        return bool(self.waiting or self.running)

    def _admit(self):
        admitted, still_waiting = [], []
        for req in self.waiting:
            slot = self.cache.alloc_slot(
                len(req.prompt) + len(req.generated)) \
                if len(self.running) < self.cache.max_batch else None
            if slot is None:
                still_waiting.append(req)
                continue
            req.slot = slot
            self.running[slot] = req
            admitted.append(req)
        self.waiting = still_waiting
        for req in admitted:
            tok = self.model.paged_prefill(self.cache, req.slot,
                                           prefill_ids(req),
                                           temperature=self.temperature,
                                           generator=self.generator)
            self._last_tok[req.slot] = tok
            self._remaining[req.slot] = \
                req.max_new_tokens - len(req.generated) - 1
            req.generated.append(int(tok))
            self._maybe_finish(req.slot)

    def _preempt(self, slot):
        """The victim loses its slot and blocks now and rejoins the front
        of the waiting queue with its generated tokens kept."""
        req = self.running.pop(slot)
        self.cache.free_slot(slot)
        req.slot = -1
        self.waiting.insert(0, req)
        self.preemptions += 1
        _PREEMPTS.inc()

    def _maybe_finish(self, slot):
        req = self.running.get(slot)
        if req is None:
            return
        done = self._remaining[slot] <= 0 or (
            self.eos_token_id is not None
            and req.generated and req.generated[-1] == self.eos_token_id)
        if done:
            self.cache.free_slot(slot)
            del self.running[slot]
            self.finished[req.rid] = req

    def step(self):
        """Admit waiting prompts, then decode one token for all live
        slots. Returns the list of (rid, token) decoded this step."""
        self._admit()
        if not self.running:
            return []
        active = np.zeros((self.cache.max_batch,), bool)
        for slot in self.running:
            active[slot] = True
        lens = self.cache.seq_lens
        for slot in list(self.running):
            denied = self.cache.ensure_capacity(slot, int(lens[slot]) + 1)
            if not denied:
                req = self.running[slot]
                if denied.reason == CapacityError.SEQ_LIMIT:
                    raise RuntimeError(
                        f"request {req.rid} outgrew max_blocks_per_seq: "
                        f"{denied.detail}")
                if len(self.running) == 1:
                    raise RuntimeError(
                        f"KV pool exhausted: request {req.rid} needs "
                        f"{math.ceil((int(lens[slot]) + 1) / self.cache.block_size)} "
                        f"blocks but the pool has only "
                        f"{self.cache.num_blocks - 1} usable and no other "
                        "running request to wait for; increase num_blocks")
                self._preempt(slot)
                active[slot] = False
        if not self.running:
            return []
        toks = self.model.paged_decode_step(
            self.cache, self._last_tok, active,
            temperature=self.temperature, kernel_mode=self.kernel_mode,
            generator=self.generator)
        out = []
        for slot, req in list(self.running.items()):
            t = int(toks[slot])
            req.generated.append(t)
            self._last_tok[slot] = t
            self._remaining[slot] -= 1
            out.append((req.rid, t))
            self._maybe_finish(slot)
        return out

    def run_to_completion(self):
        """Drain all requests; returns {rid: generated token list}."""
        while self.has_work:
            self.step()
        return {rid: req.generated for rid, req in self.finished.items()}
