"""Paged-decode attention kernels and their plain version (mirrors
``paddle_tpu/kernels/pallas/paged_attention.py``).

One query token per slot attends that slot's pages of a shared pool:
q [B, Hq, D]; k_pool/v_pool [NB, bs, Hk, D]; block_tables [B, MBPS] int32;
seq_lens [B] int32; returns [B, Hq, D], with scale 1/sqrt(D). Positions
>= seq_len are masked
and a slot with seq_len 0 gives zeros. GQA is folded: query head h reads
kv head h // G. Int8 pools come with ``k_scale``/``v_scale`` [NB, bs, Hk]
float32, one scale per (row, kv head): a row is dequantized as
``(pool.float() * scale).to(q.dtype)`` before the dot products.

- ``paged_decode_attention_kernel`` launches ``csrc/paged_decode.cu``
  (Hopper counterpart of the Pallas ``_decode_kernel``, :133 there, and of
  ``_decode_kernel_q``, :156, for int8 pools): one cluster of C CTAs per
  (slot, kv head) splits the slot's live pages, stages them in shared
  memory with ``cp.async`` and merges its partials through distributed
  shared memory (``decode_cluster_plan`` picks C and the staged chunk).
- ``paged_decode_attention_chunked`` launches ``csrc/paged_decode_split.cu``
  (counterpart of ``_decode_kernel_chunked``, :186 there, both pool
  types) for long tables: one launch of clusters of up to 16 CTAs per
  (slot, kv head), each warp streaming 16-row blocks of its CTA's share
  through its own ``cp.async`` ring, the partials merged through
  distributed shared memory (``split_cluster_plan`` picks C).
- ``paged_decode_attention_dense`` is the plain version, a copy of
  ``paddle_tpu/inference/paged.py:1059`` (int8 pools dequantized in the
  gather, as its ``_gather_kv`` does).

Both wrappers take the plain version for CPU tensors; for CUDA tensors
they launch their kernel or raise. Each counts its bf16-pool launches in
``launches`` and its int8-pool launches in ``launches_q``. The kernels
take bf16 queries over bf16 pools (int8 pools with their scales), head
dims 64 and 128 and GQA groups 1, 2, 4 and 8 (``decode_kernel_takes``,
which ``inference.paged.paged_decode_attention`` routes by).

``paged_decode_attention_simt`` launches ``csrc/paged_decode_simt.cuh``
(the CUDA cores, float32 logits and sums) for the rest: float32, fp16
and bf16 queries over pools of their dtype or int8, any GQA group and
head dims up to ``SIMT_MAX_HEAD_DIM`` (the JAX package's wrappers check
none of these): one cluster per (slot, kv head) with the group's heads in
each CTA, the live pages split over the cluster and streamed by each warp
through its own ``cp.async`` ring (``simt_decode_plan`` picks every size).
It counts as the two wrappers above.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from . import _build

_NEG = -1e30
# shared memory a block may use on Hopper (227 KB of the SM's 256 KB)
SMEM_PER_BLOCK = 227 * 1024
# cluster sizes of the per-page route (8 is the portable maximum) and of
# the split route (16 needs the non-portable cluster size), and the
# kernels' warps per CTA
_CLUSTER_SIZES = (1, 2, 4, 8)
_SPLIT_CLUSTER_SIZES = (1, 2, 4, 8, 16)
_DECODE_WARPS = 4
# the split route grows its clusters until the grid holds this many CTAs
# per SM (``split_cluster_plan``)
_SPLIT_CTAS_PER_SM = 2


def _gather_kv(pool, idx, scale, dtype):
    """A pool's rows at block ids ``idx``; an int8 pool's dequantized
    into ``dtype``."""
    g = pool[idx]
    if scale is None:
        return g
    return (g.float() * scale[idx][..., None]).to(dtype)


def paged_decode_attention_dense(q, k_pool, v_pool, block_tables, seq_lens,
                                 k_scale=None, v_scale=None):
    """Gather each slot's blocks ([B, S_max, Hk, D], dequantized for int8
    pools), mask positions >= seq_len, group-folded GQA attention with
    float32 logits; probabilities are cast to V's dtype before P @ V,
    which accumulates in float32."""
    b, hq, d = q.shape
    _, bs, hk, _ = k_pool.shape
    g = hq // hk
    s_max = block_tables.shape[1] * bs
    idx = block_tables.long()
    k = _gather_kv(k_pool, idx, k_scale, q.dtype).reshape(b, s_max, hk, d)
    v = _gather_kv(v_pool, idx, v_scale, q.dtype).reshape(b, s_max, hk, d)
    sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, d)
    logits = torch.einsum("bngd,btnd->bngt", qg.float(), k.float()) \
        * sm_scale
    pos = torch.arange(s_max, device=q.device)
    mask = (pos[None, :] < seq_lens[:, None].long())[:, None, None, :]
    logits = logits.masked_fill(~mask, _NEG)
    probs = torch.softmax(logits, dim=-1)
    # fully masked (empty) slots: the softmax of all -1e30 is uniform
    # junk; zero it so the output is exactly 0
    probs = probs * mask
    out = torch.einsum("bngt,btnd->bngd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, hq, d).to(q.dtype)


# what the decode kernels are built for (``decode_kernel_takes``)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)


def decode_kernel_takes(q, k_pool, v_pool, k_scale=None):
    """True when the decode kernels (B4-B6q) take these operands by dtype
    and shape: q bf16 [B, Hq, D], pools [NB, bs, Hk, D] of one shape, bf16
    or (with ``k_scale``) int8, D in ``KERNEL_HEAD_DIMS`` and Hq a multiple
    of Hk by a group in ``KERNEL_GROUPS``. Pure: the router and the
    wrappers' checks (``_check_cuda_args``) share it."""
    pool_dtype = torch.int8 if k_scale is not None else torch.bfloat16
    d, hq, hk = q.shape[-1], q.shape[1], k_pool.shape[2]
    return (q.dtype == torch.bfloat16 and k_pool.dtype == pool_dtype
            and v_pool.dtype == pool_dtype and d in KERNEL_HEAD_DIMS
            and k_pool.shape[-1] == d and v_pool.shape == k_pool.shape
            and hk > 0 and hq % hk == 0 and hq // hk in KERNEL_GROUPS)


# what ``paged_decode_attention_simt`` takes: query dtypes by the tag of
# their source and C entry (``csrc/paged_decode_simt_<tag>.cu``), and head
# dims up to this
_SIMT_DTYPES = {torch.float32: "f32", torch.float16: "f16",
                torch.bfloat16: "bf16"}
SIMT_MAX_HEAD_DIM = 1024
# the CUDA cores' decode kernel (``simt_decode_plan``): streaming warps a
# CTA at most (the CTA runs that many), float32 accumulators a lane (heads
# x columns of P V), heads a CTA, the K and V bytes a warp's block of rows
# aims at, ring stages a warp
_SIMT_WARPS = 4
_SIMT_ACC = 64
_SIMT_HEADS = 8
_SIMT_BLOCK_BYTES = 8 * 1024
_SIMT_STAGES = 3
# the cluster grows until the grid holds _SIMT_GRID_PER_SM CTAs an SM; a
# CTA's shared memory is planned for as many CTAs an SM as the grid puts
# there, at most _SIMT_CTAS_PER_SM
_SIMT_GRID_PER_SM = 2
_SIMT_CTAS_PER_SM = 4


def _pow2_at_least(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def _align16(n):
    return -(-n // 16) * 16


def simt_smem_bytes(npages, d, elem_bytes, quantized, heads, rows,
                    key_stride, value_stride, warps, stages, cluster):
    """Dynamic shared memory of ``csrc/paged_decode_simt.cuh`` (its
    ``layout``): the rank's share of block ids; Q as f32 [GC][dq] (GC the
    heads rounded up to a power of two, dq the row's 16-byte chunks in
    elements); P f32 [warps][GC][rows]; the merges' weights f32
    [warps + cluster + 2][GC]; the streaming warps' rings, stages of K
    rows [rows][key_stride] and V rows [rows][value_stride] bytes (int8
    pools: and their two f32 scales a row), whose bytes the warps'
    partials (m, l, O f32 [warps][GC][2 + D]) reuse; past them the
    cluster's slots [cluster][GC][2 + D] f32."""
    s = 1 if quantized else elem_bytes
    dq = -(-d * s // 16) * (16 // s)
    gc = _pow2_at_least(heads)
    stage = rows * (key_stride + value_stride) + (8 * rows if quantized
                                                  else 0)
    rings = warps * stages * stage
    partials = _align16(warps * gc * (2 + d) * 4)
    return (_align16(-(-npages // cluster) * 4) + gc * dq * 4 +
            warps * gc * rows * 4 + _align16((warps + cluster + 2) * gc * 4)
            + max(rings, partials) + cluster * gc * (2 + d) * 4)


SimtPlan = collections.namedtuple("SimtPlan", (
    "cluster", "group_splits", "heads", "lanes_per_key", "warps", "stages",
    "copy_width", "key_stride", "value_stride", "rows", "smem"))


@functools.lru_cache(maxsize=256)
def simt_decode_plan(b, hk, g, npages, bs, d, elem_bytes, quantized,
                     num_sms, cluster=None):
    """The CUDA cores' decode kernel's sizes (a ``SimtPlan``), from shapes
    alone, before any launch; the first nine fields are its C entry's
    plan arguments.

    - Rows: a warp takes blocks of ``rows`` key rows (32, halved while its
      K and V bytes pass ``_SIMT_BLOCK_BYTES``, at least 4), with
      ``lanes_per_key`` = 32 / rows lanes on each key's 16-byte chunks.
      K rows are padded to ``key_stride`` bytes, an odd multiple of 16
      times the lanes a key (any multiple of 16 at 8 lanes), so that a
      quarter-warp's 16-byte reads hit 8 bank groups; V rows to
      ``value_stride``, the row's bytes rounded up to 16.
    - Heads: a lane accumulates heads x ceil(D / 32) (columns rounded up
      to a power of two, at least 2) float32 of P V, at most ``_SIMT_ACC``
      and ``_SIMT_HEADS`` heads a CTA; ``group_splits`` CTAs share a kv
      head where the group holds more.
    - Copy width: 16 bytes where the row's bytes allow, else 8, 4, 2, 1
      (the last two by loads, not cp.async).
    - Cluster: the smallest of 1, 2, 4, 8, 16 whose grid (B x Hk x
      ``group_splits`` x C) holds ``_SIMT_GRID_PER_SM`` CTAs an SM, never
      more than the table's pages, and no larger than one whose CTA fits
      the shared memory of an SM shared by as many CTAs as that grid puts
      on it (1 to ``_SIMT_CTAS_PER_SM``). ``cluster`` forces C; it must fit
      one CTA.
    - Warps and stages: the CTA runs 4 warps; as many of them stream
      (``warps``) as the largest share has blocks, each through a ring of
      stages (up to 3) until every block of it is in flight at once;
      fewer stages, then fewer streaming warps, until the CTA fits.

    Raises ``ValueError`` where nothing fits a CTA's shared memory, or
    for a forced cluster size outside those."""
    s = 1 if quantized else elem_bytes
    rowb = d * s
    nchunk = -(-rowb // 16)
    rows = 32
    while rows > 4 and rows * 2 * nchunk * 16 > _SIMT_BLOCK_BYTES:
        rows //= 2
    lpk = 32 // rows
    groups = nchunk
    while lpk < 8 and groups % (2 * lpk) != lpk:
        groups += 1
    copy_width = next(w for w in (16, 8, 4, 2, 1) if rowb % w == 0)
    nj = max(2, _pow2_at_least(-(-d // 32)))
    most = min(_SIMT_HEADS, _SIMT_ACC // nj)
    splits = -(-g // most)
    heads = -(-g // splits)
    splits = -(-g // heads)

    def fit(c, room):
        """(warps, stages, bytes) of the first layout that fits ``room``
        at cluster size ``c``, or None."""
        nblk = max(-(-(-(-npages // c) * bs) // rows), 1)
        warps = min(_SIMT_WARPS, nblk)
        stages = min(_SIMT_STAGES, -(-nblk // warps))
        tries = [(warps, st) for st in range(stages, 0, -1)] + \
            [(w, 1) for w in range(warps - 1, 0, -1)]
        for w, st in tries:
            n = simt_smem_bytes(npages, d, elem_bytes, quantized, heads,
                                rows, groups * 16, nchunk * 16, w, st, c)
            if n <= room:
                return w, st, n
        return None

    if cluster is None:
        choice = None
        for c in _SPLIT_CLUSTER_SIZES:
            if c > max(npages, 1):
                break
            ctas = b * hk * splits * c
            per_sm = min(max(-(-ctas // num_sms), 1), _SIMT_CTAS_PER_SM)
            f = fit(c, SMEM_PER_BLOCK // per_sm)
            if f is None:
                break
            choice = c, f
            if ctas >= _SIMT_GRID_PER_SM * num_sms:
                break
        if choice is None:
            choice = 1, fit(1, SMEM_PER_BLOCK)
    elif cluster not in _SPLIT_CLUSTER_SIZES:
        raise ValueError(f"simt_decode_plan: cluster {cluster} not in "
                         f"{_SPLIT_CLUSTER_SIZES}")
    else:
        choice = cluster, fit(cluster, SMEM_PER_BLOCK)
    cluster, f = choice
    if f is None:
        raise ValueError(
            f"paged_decode_simt: a {npages}-page table of head_dim {d} "
            f"({'int8' if quantized else f'{elem_bytes}-byte'} pools, "
            f"{heads} heads a CTA) does not fit {SMEM_PER_BLOCK} bytes of "
            f"shared memory at cluster size {cluster}, even with one warp "
            f"and one stage of {rows} rows")
    warps, stages, smem = f
    return SimtPlan(cluster, splits, heads, lpk, warps, stages, copy_width,
                    groups * 16, nchunk * 16, rows, smem)


def simt_decode_schedule(length, npages, bs, plan):
    """Where the CUDA cores' decode kernel puts each live row of a slot of
    ``length`` keys: a list of (rank, warp, stage, first row, rows) per
    block, in the kernel's order. Rank r takes its pages of
    ``decode_cluster_shares``; its live rows go in blocks of
    ``plan.rows``, block j to warp j % warps as that warp's block
    i = j // warps, in ring stage i % stages."""
    out = []
    for rank, (p0, p1) in enumerate(decode_cluster_shares(
            length, bs, npages, plan.cluster)):
        nrows = max(min(p1 * bs, min(int(length), npages * bs)) - p0 * bs,
                    0)
        for j in range(-(-nrows // plan.rows)):
            first = j * plan.rows
            out.append((rank, j % plan.warps,
                        (j // plan.warps) % plan.stages, p0 * bs + first,
                        min(plan.rows, nrows - first)))
    return out


def _check_cuda_args(what, q, k_pool, v_pool, block_tables, seq_lens,
                     k_scale, v_scale):
    """Validate a CUDA launch; returns (quantized, B, Hq, Hk, D, bs,
    MBPS)."""
    b, hq, d = q.shape
    nb, bs, hk, _ = k_pool.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: give both k_scale and v_scale or "
                         f"neither")
    quantized = k_scale is not None
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    if not decode_kernel_takes(q, k_pool, v_pool, k_scale):
        raise ValueError(
            f"{what}: the kernels take bfloat16 queries over {pool_dtype} "
            f"pools, head_dim in {KERNEL_HEAD_DIMS} and GQA groups in "
            f"{KERNEL_GROUPS}; got q {q.dtype} {tuple(q.shape)}, pools "
            f"{k_pool.dtype} {tuple(k_pool.shape)} / {v_pool.dtype} "
            f"{tuple(v_pool.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned CUDA tensor, got {t.dtype} "
                             f"on {t.device}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if not t.is_cuda or t.dtype != torch.float32 or \
                    not t.is_contiguous() or \
                    tuple(t.shape) != (nb, bs, hk):
                raise ValueError(f"{what}: {name} must be a contiguous "
                                 f"float32 CUDA tensor of shape "
                                 f"{(nb, bs, hk)}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
    for name, t in (("block_tables", block_tables),
                    ("seq_lens", seq_lens)):
        if not t.is_cuda or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"{what}: tables {tuple(block_tables.shape)} / "
                         f"lens {tuple(seq_lens.shape)} vs batch {b}")
    return quantized, b, hq, hk, d, bs, block_tables.shape[1]


def _scale_ptrs(k_scale, v_scale):
    return ([] if k_scale is None
            else [k_scale.data_ptr(), v_scale.data_ptr()])


def decode_smem_bytes(rows, npages, d, g, quantized, stages, cluster):
    """Dynamic shared memory of the per-page kernel (``smem_bytes`` in
    ``csrc/paged_decode.cu``): the table row's block ids, then per stage
    the padded bf16 K and V tiles ([rows][D + 8]); for int8 pools one
    dequantized pair of tiles plus, per stage, the raw int8 rows and their
    f32 scales. The warps' f32 partials reuse the bytes afterwards; past
    them lie the cluster's f32 slots (m, l, O of each rank)."""
    tile = 2 * rows * (d + 8) * 2
    raw = rows * (2 * d + 8) if quantized else 0
    staging = -(-npages * 4 // 16) * 16 + (
        tile + stages * raw if quantized else stages * tile)
    return max(staging, _DECODE_WARPS * g * (d + 2) * 4) + \
        cluster * (2 * g + g * d) * 4


def decode_cluster_shares(length, bs, npages, cluster):
    """Each cluster rank's live pages ``(begin, end)`` for a slot of
    ``length`` keys: the kernel's share formula, ceil(live / C) pages each
    in rank order (lengths past the table attend the whole table)."""
    live = -(-min(int(length), npages * bs) // bs)
    share = -(-live // cluster)
    out = []
    for rank in range(cluster):
        begin = min(rank * share, live)
        out.append((begin, min(begin + share, live)))
    return out


@functools.lru_cache(maxsize=256)
def decode_cluster_plan(b, hk, g, npages, bs, d, quantized, num_sms):
    """``(cluster, chunk_pages, stages)`` for the per-page kernel.

    The cluster size C is the smallest of 1, 2, 4, 8 that gives every SM a
    CTA (B * Hk * C >= ``num_sms``), never more than the table's pages. A
    rank's share is at most ceil(npages / C) pages; it is staged at once
    when it fits half of a block's shared memory (two CTAs an SM), else
    in chunks through a two-stage ring. Raises ``ValueError`` when not one
    page can be staged."""
    cluster = 1
    for c in _CLUSTER_SIZES:
        if c > max(npages, 1):
            break
        cluster = c
        if b * hk * c >= num_sms:
            break
    share = max(-(-npages // cluster), 1)
    budget = SMEM_PER_BLOCK // 2

    def fits(pages, stages):
        rows = -(-pages * bs // 16) * 16
        return decode_smem_bytes(rows, npages, d, g, quantized, stages,
                                 cluster) <= budget

    if fits(share, 1):
        return cluster, share, 1
    if not fits(1, 2):
        raise ValueError(
            f"paged_decode: a {bs}-row page of head_dim {d} "
            f"({'int8' if quantized else 'bf16'} pools) and a {npages}-page "
            f"table do not fit two stages in {budget} bytes of shared "
            f"memory")
    pages = 1
    while pages + 1 < share and fits(pages + 1, 2):
        pages += 1
    return cluster, pages, 2


def split_smem_bytes(npages, d, g, quantized, cluster):
    """Dynamic shared memory of the split route's kernel (``slots_at`` in
    ``csrc/paged_decode_split.cu``): the table row's block ids, then each
    of the 4 warps' 16-row stages (bf16 pools: one stage of a padded K and
    V tile [16][D + 8] bf16; int8 pools: two of raw rows [16][D] int8 with
    their f32 scales, after one such bf16 tile for K, then V); the warps'
    f32 partials reuse those bytes, and past them lie the cluster's f32
    slots (m, l, O of each rank)."""
    tile = 16 * (d + 8) * 2
    warp = tile + 2 * 16 * (2 * d + 8) if quantized else 2 * tile
    rings = -(-npages * 4 // 16) * 16 + _DECODE_WARPS * warp
    partials = _DECODE_WARPS * g * (d + 2) * 4
    return max(rings, partials) + cluster * (2 * g + g * d) * 4


@functools.lru_cache(maxsize=256)
def split_cluster_plan(b, hk, g, npages, d, quantized, num_sms,
                       cluster=None):
    """Cluster size C of the split route (long tables,
    ``paged_decode_attention_chunked``): the smallest of 1, 2, 4, 8, 16
    whose grid holds ``_SPLIT_CTAS_PER_SM`` CTAs per SM (B * Hk * C >= that
    many times ``num_sms``), never more than the table's pages and never
    so many that two CTAs no longer share an SM (``split_smem_bytes``: the
    cluster's slots grow with C). ``cluster`` forces C; it must fit one
    CTA's shared memory. Each rank streams its share of a slot's live
    pages 16 rows at a time, every warp on its own, so no chunk size is
    planned. Raises ``ValueError`` for a C outside those sizes or one that
    does not fit."""
    fits = lambda c, room: split_smem_bytes(npages, d, g, quantized,
                                            c) <= room
    if cluster is None:
        cluster = 1
        for c in _SPLIT_CLUSTER_SIZES:
            if c > max(npages, 1) or not fits(c, SMEM_PER_BLOCK // 2):
                break
            cluster = c
            if b * hk * c >= _SPLIT_CTAS_PER_SM * num_sms:
                break
    elif cluster not in _SPLIT_CLUSTER_SIZES:
        raise ValueError(f"split_cluster_plan: cluster {cluster} not in "
                         f"{_SPLIT_CLUSTER_SIZES}")
    if not fits(cluster, SMEM_PER_BLOCK):
        raise ValueError(
            f"paged_decode_split: a {npages}-page table of head_dim {d} "
            f"({'int8' if quantized else 'bf16'} pools) at cluster size "
            f"{cluster} needs "
            f"{split_smem_bytes(npages, d, g, quantized, cluster)} bytes "
            f"of shared memory, more than {SMEM_PER_BLOCK}")
    return cluster


def paged_decode_attention_kernel(q, k_pool, v_pool, block_tables,
                                  seq_lens, k_scale=None, v_scale=None):
    """Per-page decode: grid (B, Hk, C) in clusters of C CTAs, one cluster
    per slot and kv head (with its G query heads), the slot's live pages
    split over the cluster (``decode_cluster_plan``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_dense(q, k_pool, v_pool, block_tables,
                                            seq_lens, k_scale, v_scale)
    quantized, b, hq, hk, d, bs, mbps = _check_cuda_args(
        "paged_decode", q, k_pool, v_pool, block_tables, seq_lens, k_scale,
        v_scale)
    sm_scale = 1.0 / math.sqrt(d)
    num_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    cluster, cpp, _ = decode_cluster_plan(b, hk, hq // hk, mbps, bs, d,
                                          quantized, num_sms)
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = "paged_decode_i8" if quantized else "paged_decode_bf16"
    err = getattr(lib, fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(k_scale, v_scale), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, hq, hk, d, bs, mbps, cpp,
        cluster, float(sm_scale), stream)
    _build.check(err, fn)
    if quantized:
        paged_decode_attention_kernel.launches_q += 1
    else:
        paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
paged_decode_attention_kernel.launches_q = 0


def paged_decode_attention_chunked(q, k_pool, v_pool, block_tables,
                                   seq_lens, k_scale=None, v_scale=None):
    """Split-KV decode for long tables: one launch, grid (B, Hk, C) in
    clusters of C CTAs per slot and kv head, the slot's live pages split
    over the cluster, streamed by each warp on its own and merged in rank
    0's shared memory (``split_cluster_plan``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_dense(q, k_pool, v_pool, block_tables,
                                            seq_lens, k_scale, v_scale)
    quantized, b, hq, hk, d, bs, mbps = _check_cuda_args(
        "paged_decode_split", q, k_pool, v_pool, block_tables, seq_lens,
        k_scale, v_scale)
    sm_scale = 1.0 / math.sqrt(d)
    num_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    cluster = split_cluster_plan(b, hk, hq // hk, mbps, d, quantized,
                                 num_sms)
    out = torch.empty_like(q)
    lib = _build.load("paged_decode_split")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = "paged_decode_split_i8" if quantized else "paged_decode_split_bf16"
    err = getattr(lib, fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(k_scale, v_scale), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, hq, hk, d, bs, mbps,
        cluster, float(sm_scale), stream)
    _build.check(err, fn)
    if quantized:
        paged_decode_attention_chunked.launches_q += 1
    else:
        paged_decode_attention_chunked.launches += 1
    return out


paged_decode_attention_chunked.launches = 0
paged_decode_attention_chunked.launches_q = 0


def paged_decode_attention_simt(q, k_pool, v_pool, block_tables, seq_lens,
                                k_scale=None, v_scale=None):
    """Decode on the CUDA cores: grid (B, Hk x group splits, C) in
    clusters of C CTAs, one cluster per slot and kv head with the group's
    query heads in each CTA, the slot's live pages split over the cluster
    (``simt_decode_plan``). q [B, Hq, D] float32, fp16 or bf16; pools
    [NB, bs, Hk, D] of q's dtype, or int8 with ``k_scale``/``v_scale``
    [NB, bs, Hk] float32; any group Hq / Hk; D up to
    ``SIMT_MAX_HEAD_DIM``; pools aligned to the plan's copy width. Raises
    on anything else; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_dense(q, k_pool, v_pool, block_tables,
                                            seq_lens, k_scale, v_scale)
    what = "paged_decode_simt"
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: give both k_scale and v_scale or "
                         f"neither")
    quantized = k_scale is not None
    b, hq, d = q.shape
    nb, bs, hk, _ = k_pool.shape
    pool_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _SIMT_DTYPES:
        raise ValueError(f"{what}: q must be float32, float16 or bfloat16, "
                         f"got {q.dtype}")
    for name, t, dt in (("q", q, q.dtype), ("k_pool", k_pool, pool_dtype),
                        ("v_pool", v_pool, pool_dtype)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    tensors = [("block_tables", block_tables, torch.int32),
               ("seq_lens", seq_lens, torch.int32)]
    if quantized:
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    for name, t, dt in tensors:
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if quantized and (tuple(k_scale.shape) != (nb, bs, hk) or
                      v_scale.shape != k_scale.shape):
        raise ValueError(f"{what}: scales must be [{nb}, {bs}, {hk}]")
    if k_pool.shape[-1] != d or v_pool.shape != k_pool.shape or \
            d > SIMT_MAX_HEAD_DIM or hk <= 0 or hq % hk:
        raise ValueError(f"{what}: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}: "
                         f"head dims must match and be at most "
                         f"{SIMT_MAX_HEAD_DIM}, Hq a multiple of Hk")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"{what}: tables {tuple(block_tables.shape)} / "
                         f"lens {tuple(seq_lens.shape)} vs batch {b}")
    mbps = block_tables.shape[1]
    num_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = simt_decode_plan(b, hk, hq // hk, mbps, bs, d, q.element_size(),
                            quantized, num_sms)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % plan.copy_width:
            raise ValueError(f"{what}: {name} must be aligned to "
                             f"{plan.copy_width} bytes (its rows' copy "
                             f"width)")
    out = torch.empty_like(q)
    name = f"paged_decode_simt_{_SIMT_DTYPES[q.dtype]}"
    lib = _build.load(name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quantized \
        else (None, None)
    err = getattr(lib, name)(
        int(quantized), q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, hq,
        hk, d, bs, mbps, *plan[:9], float(1.0 / math.sqrt(d)), stream)
    _build.check(err, what)
    if quantized:
        paged_decode_attention_simt.launches_q += 1
    else:
        paged_decode_attention_simt.launches += 1
    return out


paged_decode_attention_simt.launches = 0
paged_decode_attention_simt.launches_q = 0
