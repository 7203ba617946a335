"""Flash attention on the Paddle layout [B, S, H, D] (mirrors
``paddle_tpu/kernels/flash_attention.py`` and the Pallas kernels with their
custom VJP, ``paddle_tpu/kernels/pallas/flash_attention.py:581-850``).

Entry points: ``scaled_dot_product_attention`` (the dense route of GPT,
Llama and ViT; with a mask the plain ``sdpa_masked_plain``),
``flash_attention`` (Pallas :753: a caller's scale, segment ids and
positions, LSE), ``flash_attn_varlen`` (Pallas :836: packed sequences
from ``cu_seqlens``) and ``flash_attn_unpadded`` (the kernels module's
:69: output dropout and the cast to q's dtype). All have native GQA
(Hq = G * Hk; KV heads are expanded only for a bf16 group that does not
divide 64, the ``expanded`` route) and go through
``FlashAttention``. Its forward is ``flash_fwd.cu``, the Hopper
counterpart of the Pallas ``_fwd_kernel`` (:281 there); its backward
computes Delta = rowsum(dO * O) in PyTorch and then launches
``flash_bwd.cu``: ``flash_bwd_dq`` (the counterpart of ``_dq_kernel``,
:358) and ``flash_bwd_dkv`` (of ``_dkv_kernel``, :408). With segment ids
each kernel takes its segment branch (the Pallas bodies' ``has_seg``).
CPU tensors take the plain pair, ``flash_attention_plain`` and
``flash_attention_bwd_plain``: the same math in plain PyTorch.
``FLAGS_flash_kernel=plain`` (read at each call) sends CUDA tensors to the
plain pair too. The route is decided before any launch, from the device,
the dtype, the GQA group and the head dim alone (``flash_route`` for the
forward, ``flash_bwd_route`` for the backward), and counted in
``ROUTE_COUNTS`` (the forward) and ``BWD_ROUTE_COUNTS`` (the backward,
when it runs): bf16 takes the tensor-core kernels (K and V expanded along
the head axis where the group does not divide 64); float32 and fp16 take
tensor-core kernels too, fp16 on f16 ``wgmma`` (``f16``:
``flash_fwd_cuda``, ``flash_bwd_cuda``), float32 as three bf16 pieces of
every operand (``split``: ``split_bf16x3_cuda``, then
``flash_fwd_x3_cuda``, and in the backward ``flash_bwd_dq_x3_cuda`` and
``flash_bwd_dkv_x3_cuda``, each product the six terms of the pieces that
keep float32's precision), the forward at every head dim, the backward up
to head dim 128; above it their backward takes ``flash_simt.cu``
(``flash_simt_bwd_cuda``), every product a float32 FMA on the CUDA
cores. The CUDA cores' forward (``flash_simt_fwd_cuda``) is on no route.
There is no fallback: a kernel wrapper handed a tensor its kernel does
not take raises.

The kernels read q/k/v/dO through their strides (the innermost one must be
1 and the others multiples of 8 elements), so the non-contiguous q/k/v
views that GPT's fused qkv projection yields are read in place; O, LSE,
dQ, dK and dV are written contiguous. Segment ids and positions are int32
[B, S], contiguous.

Semantics shared by all: scale 1/sqrt(D) unless the caller gives one,
logits in float32, masked entries at -1e30, a fully masked row gives
O = 0, LSE = +1e30 and zero gradients. Without segments, causal masking
is bottom-right aligned (query i sees keys j <= i + Sk - Sq). With
segments (Pallas ``_block_mask``, :245) query i sees key j when their ids
are equal and, if causal, when q_pos[i] >= kv_pos[j]; the kv ids default
to q's and the positions to ``arange``.
"""

from __future__ import annotations

import math

import torch

from ..amp import _state as _AMP
from ..amp import cast_args as _amp_cast
from ..core import flags as _flags
from ..core.dispatch import op_hook
from ..nn.functional import dropout as _dropout
from . import _build

_NEG = -1e30
_BIG = 1e30
# the head dims the kernels are built for up to 256; ``FlashAttention``
# zero-pads any other D up to 256 to the next of these, and a D above 256
# to the next multiple of 128, as the Pallas kernel pads it
# (``padded_head_dim``). At 64 and 128 bf16 B1 runs on mma.sync (its
# segment branch, fp16 and float32 on one warpgroup's wgmma), B2 and B3 on
# one warpgroup's wgmma; at 256 B1 runs a TMA producer and two wgmma
# consumer warpgroups, B2 and B3 two warpgroups; above 256 each kernel
# streams the head dim through its ring in chunks (B1 in float32 from
# 256)
_KERNEL_DIMS = (64, 128, 256)
_WIDE_STEP = 128
_MODES = ("auto", "plain")
# the kernels fold the G query heads of a kv head into 64-row CTAs
_FOLD = 64
# ``FlashAttention``'s routing decisions (``flash_route``), one a forward
# call: ``kernel`` (B1-B3 as they are), ``expanded`` (B1-B3 on K and V
# expanded along the head axis), ``f16`` (fp16 on the tensor cores),
# ``split`` (float32, as three bf16 pieces), ``forced``
# (FLAGS_flash_kernel=plain: the plain pair) and ``cpu`` (CPU tensors take
# the plain pair)
ROUTE_COUNTS = {"kernel": 0, "expanded": 0, "f16": 0, "split": 0,
                "forced": 0, "cpu": 0}
# the backward's (``flash_bwd_route``), one a backward call: the same, with
# ``f16`` and ``split`` up to head dim 128 and ``simt`` above it
# (``flash_simt.cu``)
BWD_ROUTE_COUNTS = {"kernel": 0, "expanded": 0, "f16": 0, "split": 0,
                    "simt": 0, "forced": 0, "cpu": 0}
# the dtypes ``flash_simt.cu`` takes, by their code in its C entry points
_SIMT_DTYPES = {torch.float32: 0, torch.float16: 1}
# the element types of ``flash_bwd.cu``'s C entry points (and of
# ``flash_fwd_tc``, which takes the last two): bf16, fp16, and float32 as
# three bf16 pieces ([3, B, S, H, D])
_BWD_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_BWD_PIECES = 2
# the head dims B2-B3 take fp16 and float32 at, and B1's tc kernel
# (FlashAttention pads any D up to 128 to one of them; B1 takes both
# dtypes at every kernel head dim)
_TC_DIMS = (64, 128)
# the plain pair takes its query rows in chunks so that one float32
# [B, Hk, G, rows, Sk] tensor stays below this many elements (1 GiB): at
# packed lengths of thousands the whole logits tensor would not fit
_PLAIN_ELEMS = 1 << 28


def _valid_mask(Sq, Sk, causal, device):
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=device)[None, :]
    return kj <= qi


def _scale(scale, D):
    return float(scale if scale is not None else 1.0 / math.sqrt(D))


def _segments(q, k, q_segment_ids, kv_segment_ids, q_positions,
              kv_positions):
    """None without ``q_segment_ids`` (as Pallas :760, the other three are
    then ignored); else (qseg, kseg, qpos, kpos), int32 [B, S] on q's
    device, contiguous, with the defaults of Pallas :803-817: kv ids are
    q's, positions ``arange``."""
    if q_segment_ids is None:
        return None
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device).expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=q.device).expand(B, Sk)
    out = tuple(torch.as_tensor(t, device=q.device).to(torch.int32)
                .contiguous() for t in (q_segment_ids, kv_segment_ids,
                                        q_positions, kv_positions))
    for name, t, S in zip(("q_segment_ids", "kv_segment_ids",
                           "q_positions", "kv_positions"), out,
                          (Sq, Sk, Sq, Sk)):
        if tuple(t.shape) != (B, S):
            raise ValueError(f"{name} must be [{B}, {S}], got "
                             f"{tuple(t.shape)}")
    return out


def _row_mask(Sq, Sk, causal, device, seg, r0, r1):
    """Which keys query rows r0..r1-1 see, broadcastable against logits
    [B, Hk, G, rows, Sk] (``_block_mask``)."""
    if seg is None:
        return _valid_mask(Sq, Sk, causal, device)[r0:r1]
    qseg, kseg, qpos, kpos = seg
    valid = qseg[:, r0:r1, None] == kseg[:, None, :]
    if causal:
        valid &= qpos[:, r0:r1, None] >= kpos[:, None, :]
    return valid[:, None, None]


def _row_chunks(B, Sq, Hq, Sk):
    """(r0, r1) row ranges of the plain pair's chunks; one (0, 0) chunk
    when Sq is 0, so the outputs keep their shapes."""
    step = max(1, _PLAIN_ELEMS // max(1, B * Hq * Sk))
    return [(r0, min(Sq, r0 + step)) for r0 in range(0, Sq, step)] or \
        [(0, 0)]


def flash_attention_plain(q, k, v, causal=False, scale=None,
                          q_segment_ids=None, kv_segment_ids=None,
                          q_positions=None, kv_positions=None,
                          return_lse=False):
    """Plain PyTorch flash forward: q [B, Sq, Hq, D], k/v [B, Sk, Hk, D],
    optional segment ids and positions as ``flash_attention`` takes them.
    Returns O [B, Sq, Hq, D] in q's dtype and, with ``return_lse``, LSE
    float32 [B, Hq, Sq]. Normalized probabilities are cast to V's dtype
    before P @ V, which accumulates in float32."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hq % Hk:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads "
                         f"{Hk}")
    G = Hq // Hk
    sm_scale = _scale(scale, D)
    seg = _segments(q, k, q_segment_ids, kv_segment_ids, q_positions,
                    kv_positions)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for r0, r1 in _row_chunks(B, Sq, Hq, Sk):
        qg = q[:, r0:r1].reshape(B, r1 - r0, Hk, G, D).float()
        logits = torch.einsum("bsngd,btnd->bngst", qg, kf) * sm_scale
        valid = _row_mask(Sq, Sk, causal, q.device, seg, r0, r1)
        logits = logits.masked_fill(~valid, _NEG)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m) * valid
        del logits
        l = p.sum(-1, keepdim=True)
        row_live = l > 0
        probs = p / torch.where(row_live, l, torch.ones_like(l))
        del p
        out = torch.einsum("bngst,btnd->bsngd", probs.to(v.dtype).float(),
                           vf)
        outs.append(out.reshape(B, r1 - r0, Hq, D).to(q.dtype))
        if return_lse:
            lse = torch.where(row_live, m + torch.log(torch.where(
                row_live, l, torch.ones_like(l))), torch.full_like(l, _BIG))
            lses.append(lse[..., 0].reshape(B, Hq, r1 - r0))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    if not return_lse:
        return out
    return out, lses[0] if len(lses) == 1 else torch.cat(lses, -1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                              scale=None, q_segment_ids=None,
                              kv_segment_ids=None, q_positions=None,
                              kv_positions=None, dlse=None):
    """Plain PyTorch flash backward (``flash_bwd`` with ``_recompute_p``,
    ``_dq_kernel`` and ``_dkv_kernel``): returns (dQ, dK, dV) in the dtypes
    of q, k, v. P = exp(S * scale - LSE) is recomputed and masked to 0;
    Delta = rowsum(dO * O) in float32, less ``dlse`` (the cotangent of
    LSE, [B, Hq, Sq], where the caller used it); dS = P * (dO V^T - Delta)
    * scale. The kernels' casts are kept: dO is cast to q's dtype, and to
    V's before dO V^T; dS to K's dtype for dS K and to Q's for dS^T Q; P to
    dO's dtype for P^T dO; every product accumulates in float32. dK/dV sum
    over the G query heads of a group inside the products; KV is never
    expanded."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    sm_scale = _scale(scale, D)
    seg = _segments(q, k, q_segment_ids, kv_segment_ids, q_positions,
                    kv_positions)
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)                 # [B, Sq, Hq]
    delta = delta.reshape(B, Sq, Hk, G).permute(0, 2, 3, 1)[..., None]
    if dlse is not None:
        delta = delta - dlse.float().reshape(B, Hk, G, Sq)[..., None]
    lse5 = lse.reshape(B, Hk, G, Sq)[..., None]
    kf, vf = k.float(), v.float()
    dqs, dk, dv = [], None, None
    for r0, r1 in _row_chunks(B, Sq, Hq, Sk):
        qg = q[:, r0:r1].reshape(B, r1 - r0, Hk, G, D)
        dog = do[:, r0:r1].reshape(B, r1 - r0, Hk, G, D)
        valid = _row_mask(Sq, Sk, causal, q.device, seg, r0, r1)
        s = torch.einsum("bsngd,btnd->bngst", qg.float(), kf) * sm_scale
        s = s.masked_fill(~valid, _NEG)
        p = torch.where(valid, torch.exp(s - lse5[:, :, :, r0:r1]),
                        torch.zeros_like(s))
        del s
        dp = torch.einsum("bsngd,btnd->bngst", dog.to(v.dtype).float(), vf)
        ds = p * (dp - delta[:, :, :, r0:r1]) * sm_scale
        del dp
        dqs.append(torch.einsum("bngst,btnd->bsngd",
                                ds.to(k.dtype).float(), kf)
                   .reshape(B, r1 - r0, Hq, D).to(q.dtype))
        dk_c = torch.einsum("bngst,bsngd->btnd", ds.to(q.dtype).float(),
                            qg.float())
        dv_c = torch.einsum("bngst,bsngd->btnd", p.to(do.dtype).float(),
                            dog.float())
        dk = dk_c if dk is None else dk + dk_c
        dv = dv_c if dv is None else dv + dv_c
    dq = dqs[0] if len(dqs) == 1 else torch.cat(dqs, 1)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def split_bf16x3_plain(x, dp=None):
    """``x`` [..., D] float32 as three bf16 pieces, [3, ..., dp] (``dp``
    defaults to D; columns D .. dp - 1 zero): b0 = bf16(x), b1 = bf16(x -
    b0), b2 = bf16(x - b0 - b1), each rounded to nearest. The differences
    are exact in float32 and the last has at most 8 significant bits, so
    b0 + b1 + b2 == x wherever x's last bit lies above bf16's least
    subnormal. The plain version of ``split_bf16x3_cuda`` (bit for bit)."""
    x = x.float()
    if dp is not None:
        x = pad_head_dim(x, dp)
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    b2 = (r - b1.float()).to(torch.bfloat16)
    return torch.stack([b0, b1, b2])


# -- CUDA wrappers ----------------------------------------------------------

def _check_qkv(what, q, k, v, extra=(), fp16=False, fp16_dims=_TC_DIMS):
    """Shapes, dtype and layout the kernels take: bf16, or with ``fp16``
    also float16 at D in ``fp16_dims`` (B2, B3: 64 or 128; None: every
    kernel head dim, B1), all of one dtype; returns (B, Sq, Sk, Hq, Hk,
    D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    dtypes = (torch.bfloat16, torch.float16) if fp16 else (torch.bfloat16,)
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if not t.is_cuda or t.dtype not in dtypes or t.dtype != q.dtype or \
                t.dim() != 4 or t.stride(-1) != 1 or \
                any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must be a 4-d "
                f"{' or '.join(str(d)[6:] for d in dtypes)} CUDA tensor of "
                f"q's dtype with unit innermost stride, other strides "
                f"multiples of 8 and 16-byte alignment, got {t.dtype} on "
                f"{t.device} with strides {tuple(t.stride())}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"shaped as q {tuple(q.shape)}")
    if q.dtype == torch.float16 and fp16_dims is not None and \
            D not in fp16_dims:
        raise ValueError(f"{what}: float16 takes head_dim {fp16_dims}, got "
                         f"{D} (FlashAttention pads any head dim up to "
                         f"{fp16_dims[-1]} to one of these)")
    if not kernel_head_dim(D):
        raise ValueError(f"{what}: head_dim {D} not in {_KERNEL_DIMS} nor "
                         f"a multiple of {_WIDE_STEP} above "
                         f"{_KERNEL_DIMS[-1]} (FlashAttention pads any head "
                         f"dim to one of these)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % Hk or 64 % (Hq // Hk):
        raise ValueError(f"{what}: GQA group {Hq}/{Hk} must be an integer "
                         f"dividing 64")
    return B, Sq, Sk, Hq, Hk, D


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


_SEG_NAMES = ("q_segment_ids", "kv_segment_ids", "q_positions",
              "kv_positions")


def _check_seg(what, q, k, seg):
    """None when no segment tensor is given; else the four tensors the
    segment branch takes, each int32 [B, S] (Sq for q's, Sk for kv's),
    contiguous, on q's device. Raises on anything else, and when only some
    of the four are given (``flash_attention`` fills in the defaults)."""
    given = [t is not None for t in seg]
    if not any(given):
        return None
    if not all(given):
        raise ValueError(f"{what}: the segment branch takes all of "
                         f"{_SEG_NAMES}, got "
                         f"{[n for n, g in zip(_SEG_NAMES, given) if g]}")
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    for name, t, S in zip(_SEG_NAMES, seg, (Sq, Sk, Sq, Sk)):
        if t.device != q.device or t.dtype != torch.int32 or \
                tuple(t.shape) != (B, S) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor of shape {(B, S)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return tuple(seg)


# the classes of a (query block, key tile) pair on the kernels' segment
# branch (``pair_classes``; flash_seg.cuh ``pair_class``)
SKIP, MASKED, FULL = 0, 1, 2
# B3 (dK/dV) splits a GQA group over a cluster of two CTAs when its grid
# has fewer CTAs than this (``dkv_cluster``); at D 256 (one CTA an SM)
# below two waves of the H100's 132 SMs
_DKV_SPLIT_BELOW = 2048
_DKV_SPLIT_BELOW_256 = 2 * 132


def tile_bounds(ids, pos, block=64):
    """[id min, id max, position min, position max] of each ``block``
    consecutive tokens, from segment ids and positions int32 [B, S]:
    int32 [B, 4, ceil(S / block)], each of the four a contiguous row. The
    ragged last block is padded with its own last id and position. The
    kernels' segment branch classifies a (query block, key tile) pair by
    these (``pair_classes``); their C entry points compute the 64-token
    tiles' on the card (``flash_seg.cuh`` ``tile_bounds_kernel``), in
    this layout."""
    B, S = ids.shape
    n = -(-S // block)
    t = torch.stack([ids, pos], 1)                        # [B, 2, S]
    if n * block > S:
        t = torch.cat([t, t[:, :, -1:].expand(B, 2, n * block - S)], 2)
    t = t.view(B, 2, n, block)
    return torch.stack([t.amin(3), t.amax(3)], 2).view(B, 4, n)


def pair_classes(q_bounds, k_bounds, causal):
    """Class of every (query block, key tile) pair from their
    ``tile_bounds`` ([..., 4, nq] and [..., 4, nk]): [..., nq, nk] of
    ``SKIP`` (no entry can be visible: the id ranges do not overlap or,
    causal, every query position lies before every key position),
    ``FULL`` (every entry is: block and tile hold one id between them and,
    causal, the block's first position is not before the tile's last) or
    ``MASKED``. The kernels apply the same rule on the card
    (``flash_seg.cuh`` ``pair_class``; the forward and dQ at blocks of
    64 / G positions, dK/dV at 64-row tiles); rows and keys past the ends
    are theirs to handle."""
    q = q_bounds[..., :, :, None]
    k = k_bounds[..., :, None, :]
    live = (q[..., 0, :, :] <= k[..., 1, :, :]) & \
        (k[..., 0, :, :] <= q[..., 1, :, :])
    full = (q[..., 0, :, :] == q[..., 1, :, :]) & \
        (k[..., 0, :, :] == k[..., 1, :, :]) & \
        (q[..., 0, :, :] == k[..., 0, :, :])
    if causal:
        live &= q[..., 3, :, :] >= k[..., 2, :, :]
        full &= q[..., 2, :, :] >= k[..., 3, :, :]
    full &= live
    return torch.where(full, FULL, torch.where(live, MASKED, SKIP))


def dkv_cluster(B, Hk, G, Sk, D=128):
    """Cluster size C of B3 (dK/dV): the C CTAs of a cluster share one
    64-key tile and take G / C query heads each, their partial sums meeting
    in distributed shared memory. 2 when G is even and the grid has fewer
    than ``_DKV_SPLIT_BELOW`` CTAs (D 64, 128) or ``_DKV_SPLIT_BELOW_256``
    (D 256), else 1. On the H100, C 2 beat C 1 and C 4 at Llama-3-8B's
    B 1, S 2048 (256 CTAs) and at the 8192-token packed row (1024 CTAs)
    (``tools/torch_flash_bwd_ab.py .@1 .@2 .@4``; PERF.md). At D 256 (one
    CTA an SM) B 1, Hk 4, S 2048 is 128 CTAs whose first walks twice the
    mean's steps: C 2 took B3 from 0.370 to 0.207 ms; at V4's 512 CTAs
    (four waves, already balanced) it cost 0.266 -> 0.290 ms. Above D 256
    the kernels take no cluster: each CTA owns a column slice of dK and
    dV for the whole group."""
    if D > 256 or G % 2:
        return 1
    limit = _DKV_SPLIT_BELOW if D <= 128 else _DKV_SPLIT_BELOW_256
    return 2 if B * Hk * -(-Sk // 64) < limit else 1


def _bounds_workspace(B, S, device):
    """Room for ``tile_bounds`` of S tokens, which the segment kernels'
    C entry points fill on the card before they read it."""
    return torch.empty((B, 4, -(-S // 64)), dtype=torch.int32, device=device)


def _seg_ptrs(seg, *bounds):
    """The C entry points' segment pointers: the four tensors and the
    tile-bounds workspaces, NULL where absent (the dense branch)."""
    return [None if t is None else t.data_ptr()
            for t in (seg or (None,) * 4) + bounds]


def _count(fn, seg, D, dtype=torch.bfloat16):
    """One launch of ``fn``: dense or segment branch, and apart from
    either, the kernels above head dim 256 (``xl_launches``); a float16
    launch counts in one count alone, dense or segment: ``f16_launches``
    up to head dim 128 (B1-B3), ``f16_256_launches`` at 256 and
    ``f16_xl_launches`` above (B1)."""
    if dtype == torch.float16:
        attr = "f16_launches" if D <= _TC_DIMS[-1] else \
            "f16_256_launches" if D == _KERNEL_DIMS[-1] else "f16_xl_launches"
        setattr(fn, attr, getattr(fn, attr) + 1)
        return
    if seg is None:
        fn.launches += 1
    else:
        fn.seg_launches += 1
    if D > _KERNEL_DIMS[-1]:
        fn.xl_launches += 1


def flash_fwd_cuda(q, k, v, causal=False, scale=None, q_segment_ids=None,
                   kv_segment_ids=None, q_positions=None,
                   kv_positions=None):
    """Launch ``flash_fwd_bf16`` or, for fp16, ``flash_fwd_tc``. Returns
    (O, LSE), both contiguous. Takes bf16 or fp16 [B, S, H, D] tensors
    (strided as ``_check_qkv`` says) with D in {64, 128, 256} or a
    multiple of 128 above 256 (``kernel_head_dim``), and a GQA group G
    dividing 64, and for the segment branch all four id and position
    tensors (``_check_seg``); raises on anything else. Counts as
    ``_count`` says: bf16 ``launches`` (dense) and ``seg_launches`` apart,
    above D 256 ``xl_launches`` too; fp16 ``f16_launches`` (D 64, 128),
    ``f16_256_launches`` (D 256) or ``f16_xl_launches`` (above)."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_fwd", q, k, v, fp16=True,
                                      fp16_dims=None)
    seg = _check_seg("flash_fwd", q, k, (q_segment_ids, kv_segment_ids,
                                        q_positions, kv_positions))
    if q.dtype == torch.float16:
        out, lse = _fwd_tc("flash_fwd_tc", _BWD_DTYPES[q.dtype], q, k, v,
                           causal, scale, seg, q.dtype)
        _count(flash_fwd_cuda, seg, D, q.dtype)
        return out, lse
    bounds = (None if seg is None else _bounds_workspace(B, Sk, q.device),)
    out = torch.empty((B, Sq, Hq, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, Hq, Sq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), lse.data_ptr(),
                             *_seg_ptrs(seg, *bounds), B, Sq, Sk, Hq, Hk, D,
                             int(bool(causal)), _scale(scale, D),
                             *_strides(q, k, v), stream)
    _build.check(err, "flash_fwd_bf16")
    _count(flash_fwd_cuda, seg, D)
    return out, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.seg_launches = 0
flash_fwd_cuda.xl_launches = 0
flash_fwd_cuda.f16_launches = 0
flash_fwd_cuda.f16_256_launches = 0
flash_fwd_cuda.f16_xl_launches = 0


def _fwd_tc(what, code, q, k, v, causal, scale, seg, out_dtype):
    """One ``flash_fwd_tc`` launch on checked operands (element type
    ``code``; at ``_BWD_PIECES`` q, k, v are [3, B, S, H, D] pieces and
    the shapes are piece 0's). Returns (O [B, Sq, Hq, D] in ``out_dtype``,
    LSE), both contiguous."""
    B, Sq, Hq, D = q.shape[-4:]
    Sk, Hk = k.shape[-3], k.shape[-2]
    bounds = (None if seg is None else _bounds_workspace(B, Sk, q.device),)
    out = torch.empty((B, Sq, Hq, D), device=q.device, dtype=out_dtype)
    lse = torch.empty((B, Hq, Sq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_tc(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_seg_ptrs(seg, *bounds), B, Sq, Sk, Hq, Hk, D,
        int(bool(causal)), _scale(scale, D),
        *_strides(*(t[0] if t.dim() == 5 else t for t in (q, k, v))), stream)
    _build.check(err, what)
    return out, lse


def flash_delta(o, do, dlse=None):
    """Delta = rowsum(dO * O) in float32, [B, Hq, Sq] (LSE's layout), less
    the cotangent of LSE where the caller used it (Pallas :726-733). Plain
    PyTorch, as the JAX package computes it outside its kernels."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return delta if dlse is None else delta - dlse.float()


def _check_rowstats(what, B, Hq, Sq, *ts):
    for name, t in ts:
        if not t.is_cuda or t.dtype != torch.float32 or \
                tuple(t.shape) != (B, Hq, Sq) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"CUDA tensor of shape {(B, Hq, Sq)}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _bwd_dq(what, code, q, k, v, do, lse, delta, causal, scale, seg,
            out_dtype):
    """One ``flash_bwd_dq`` launch on checked operands (element type
    ``code``; at ``_BWD_PIECES`` q, k, v, do are [3, B, S, H, D] pieces
    and the shapes are piece 0's). Returns dQ [B, Sq, Hq, D] in
    ``out_dtype``, contiguous."""
    B, Sq, Hq, D = q.shape[-4:]
    Sk, Hk = k.shape[-3], k.shape[-2]
    bounds = (None if seg is None else _bounds_workspace(B, Sk, q.device),)
    dq = torch.empty((B, Sq, Hq, D), device=q.device, dtype=out_dtype)
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dq(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_seg_ptrs(seg, *bounds), B, Sq, Sk, Hq, Hk, D, int(bool(causal)),
        _scale(scale, D), *_strides(*(t[0] if t.dim() == 5 else t
                                      for t in (q, k, v, do))), stream)
    _build.check(err, what)
    return dq


def _bwd_dkv(what, code, q, k, v, do, lse, delta, causal, scale, seg,
             out_dtype):
    """One ``flash_bwd_dkv`` launch, as ``_bwd_dq``: (dK, dV) [B, Sk, Hk,
    D] in ``out_dtype``, summed over the G query heads of each group
    (split over a cluster of ``dkv_cluster`` CTAs where the grid is
    small)."""
    B, Sq, Hq, D = q.shape[-4:]
    Sk, Hk = k.shape[-3], k.shape[-2]
    bounds = (None, None) if seg is None else (
        _bounds_workspace(B, Sq, q.device),
        _bounds_workspace(B, Sk, q.device))
    dk = torch.empty((B, Sk, Hk, D), device=q.device, dtype=out_dtype)
    dv = torch.empty((B, Sk, Hk, D), device=q.device, dtype=out_dtype)
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dkv(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_seg_ptrs(seg, *bounds), B, Sq, Sk, Hq, Hk, D, int(bool(causal)),
        dkv_cluster(B, Hk, Hq // Hk, Sk, D), _scale(scale, D),
        *_strides(*(t[0] if t.dim() == 5 else t for t in (q, k, v, do))),
        stream)
    _build.check(err, what)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                      q_segment_ids=None, kv_segment_ids=None,
                      q_positions=None, kv_positions=None):
    """Launch ``flash_bwd_dq`` (B2): dQ [B, Sq, Hq, D] in q's dtype (bf16,
    or float16 at D 64 and 128), contiguous. ``lse`` and ``delta`` are
    float32 [B, Hq, Sq]; segments as ``flash_fwd_cuda`` takes them. Counts
    as ``_count`` says."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_bwd_dq", q, k, v,
                                      (("do", do),), fp16=True)
    _check_rowstats("flash_bwd_dq", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_bwd_dq", q, k, (q_segment_ids, kv_segment_ids,
                                           q_positions, kv_positions))
    dq = _bwd_dq("flash_bwd_dq", _BWD_DTYPES[q.dtype], q, k, v, do, lse,
                 delta, causal, scale, seg, q.dtype)
    _count(flash_bwd_dq_cuda, seg, D, q.dtype)
    return dq


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.seg_launches = 0
flash_bwd_dq_cuda.xl_launches = 0
flash_bwd_dq_cuda.f16_launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                       q_segment_ids=None, kv_segment_ids=None,
                       q_positions=None, kv_positions=None):
    """Launch ``flash_bwd_dkv`` (B3): (dK, dV) [B, Sk, Hk, D] in k's dtype
    (bf16, or float16 at D 64 and 128), contiguous, each summed over the G
    query heads of its group."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_bwd_dkv", q, k, v,
                                      (("do", do),), fp16=True)
    _check_rowstats("flash_bwd_dkv", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_bwd_dkv", q, k, (q_segment_ids, kv_segment_ids,
                                            q_positions, kv_positions))
    out = _bwd_dkv("flash_bwd_dkv", _BWD_DTYPES[q.dtype], q, k, v, do, lse,
                   delta, causal, scale, seg, q.dtype)
    _count(flash_bwd_dkv_cuda, seg, D, q.dtype)
    return out


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.seg_launches = 0
flash_bwd_dkv_cuda.xl_launches = 0
flash_bwd_dkv_cuda.f16_launches = 0


# -- float32 on the tensor cores: three bf16 pieces ---------------------------

def split_bf16x3_cuda(x, dp=None):
    """Launch ``flash_split_bf16x3`` (``flash_bwd.cu``): ``x`` [B, S, H, D]
    float32 CUDA tensor (unit innermost stride; other strides as they
    are) -> [3, B, S, H, dp] bf16, contiguous, the three pieces of every
    element with the head dim zero-padded to ``dp`` (even, >= D; default
    D, which must then be even). ``split_bf16x3_plain`` gives the same
    bits. Counts ``launches``."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 4 or \
            x.stride(-1) != 1:
        raise ValueError(f"split_bf16x3: x must be a 4-d float32 CUDA "
                         f"tensor with unit innermost stride, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device} with strides "
                         f"{tuple(x.stride())}")
    B, S, H, D = x.shape
    dp = D if dp is None else dp
    if dp < D or dp % 2:
        raise ValueError(f"split_bf16x3: padded head dim {dp} must be even "
                         f"and at least {D}")
    out = torch.empty((3, B, S, H, dp), device=x.device,
                      dtype=torch.bfloat16)
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.flash_split_bf16x3(x.data_ptr(), out.data_ptr(), B, S, H, D, dp,
                           *x.stride()[:3], stream)
    _build.check(err, "flash_split_bf16x3")
    split_bf16x3_cuda.launches += 1
    return out


split_bf16x3_cuda.launches = 0


def _piece_dim(D, wide):
    """True for a head dim the three-piece kernels take: 64 or 128 (B1-B3)
    and, with ``wide`` (B1), 256 and every multiple of 128 above it."""
    return D in _TC_DIMS or (wide and D >= _KERNEL_DIMS[-1] and
                             D % _WIDE_STEP == 0)


def _check_pieces(what, q, k, v, do=None, wide=False):
    """The three-piece operands B1-B3 take: [3, B, S, H, D] bf16 CUDA
    tensors, contiguous (``split_bf16x3_cuda``), D 64 or 128 (and with
    ``wide``, B1, 256 or a multiple of 128 above), q and dO (B2, B3)
    alike, k and v alike, G = Hq / Hk dividing 64; returns (B, Sq, Sk, Hq,
    Hk, D) of piece 0."""
    if do is None:
        do = q
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 5 or \
                t.shape[0] != 3 or not t.is_contiguous() or \
                not _piece_dim(t.shape[-1], wide):
            raise ValueError(
                f"{what}: {name} must be three bf16 pieces [3, B, S, H, D] "
                f"on the card, contiguous, D in {_TC_DIMS}"
                f"{' or a multiple of 128 from 256' if wide else ''} "
                f"(split_bf16x3_cuda), got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    B, Sq, Hq, D = q.shape[1:]
    Sk, Hk = k.shape[2], k.shape[3]
    if do.shape != q.shape or v.shape != k.shape or k.shape[1] != B or \
            k.shape[-1] != D:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do "
                         f"{tuple(do.shape)}")
    if Hq % Hk or 64 % (Hq // Hk):
        raise ValueError(f"{what}: GQA group {Hq}/{Hk} must be an integer "
                         f"dividing 64")
    return B, Sq, Sk, Hq, Hk, D


def flash_fwd_x3_cuda(qp, kp, vp, causal=False, scale=None,
                      q_segment_ids=None, kv_segment_ids=None,
                      q_positions=None, kv_positions=None):
    """Launch ``flash_fwd_tc`` (B1) on float32 operands as three bf16
    pieces each (``split_bf16x3_cuda``): (O [B, Sq, Hq, D] float32, LSE),
    contiguous; S = Q K^T and O += P V each the six terms of the pieces
    whose indices sum to at most 2, P split in registers. D 64, 128 or
    256 (``flash_fwd_tc_kernel``; 16-key stages at 256: counts
    ``launches`` (dense) and ``seg_launches``), or any multiple of 128
    above (``flash_fwd_xl_kernel`` on pieces: counts ``xl_launches``,
    dense or segment)."""
    D = _check_pieces("flash_fwd_x3", qp, kp, vp, wide=True)[-1]
    seg = _check_seg("flash_fwd_x3", qp[0], kp[0],
                     (q_segment_ids, kv_segment_ids, q_positions,
                      kv_positions))
    out = _fwd_tc("flash_fwd_x3", _BWD_PIECES, qp, kp, vp, causal, scale,
                  seg, torch.float32)
    if D <= _KERNEL_DIMS[-1]:
        _simt_count(flash_fwd_x3_cuda, seg)
    else:
        flash_fwd_x3_cuda.xl_launches += 1
    return out


flash_fwd_x3_cuda.launches = 0
flash_fwd_x3_cuda.seg_launches = 0
flash_fwd_x3_cuda.xl_launches = 0


def flash_split_fwd_cuda(q, k, v, causal=False, scale=None,
                         q_segment_ids=None, kv_segment_ids=None,
                         q_positions=None, kv_positions=None, dp=None):
    """The float32 forward on the tensor cores: q, k and v split into three
    bf16 pieces each with the head dim zero-padded to ``dp`` (a kernel
    head dim, ``padded_head_dim``; default D), then B1. Returns (O float32
    at ``dp`` columns, LSE); give ``scale`` for the true head dim."""
    pieces = [split_bf16x3_cuda(t if t.stride(-1) == 1 else t.contiguous(),
                                dp) for t in (q, k, v)]
    return flash_fwd_x3_cuda(*pieces, causal, scale=scale,
                             q_segment_ids=q_segment_ids,
                             kv_segment_ids=kv_segment_ids,
                             q_positions=q_positions,
                             kv_positions=kv_positions)


def flash_bwd_dq_x3_cuda(qp, kp, vp, dop, lse, delta, causal=False,
                         scale=None, q_segment_ids=None, kv_segment_ids=None,
                         q_positions=None, kv_positions=None):
    """Launch ``flash_bwd_dq`` (B2) on float32 operands as three bf16
    pieces each (``split_bf16x3_cuda``): dQ [B, Sq, Hq, D] float32,
    contiguous, every product the six terms of the pieces whose indices
    sum to at most 2. Counts ``launches`` (dense) and ``seg_launches``."""
    B, Sq, Sk, Hq, Hk, D = _check_pieces("flash_bwd_dq_x3", qp, kp, vp,
                                         dop)
    _check_rowstats("flash_bwd_dq_x3", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_bwd_dq_x3", qp[0], kp[0],
                     (q_segment_ids, kv_segment_ids, q_positions,
                      kv_positions))
    dq = _bwd_dq("flash_bwd_dq_x3", _BWD_PIECES, qp, kp, vp, dop, lse,
                 delta, causal, scale, seg, torch.float32)
    _simt_count(flash_bwd_dq_x3_cuda, seg)
    return dq


flash_bwd_dq_x3_cuda.launches = 0
flash_bwd_dq_x3_cuda.seg_launches = 0


def flash_bwd_dkv_x3_cuda(qp, kp, vp, dop, lse, delta, causal=False,
                          scale=None, q_segment_ids=None,
                          kv_segment_ids=None, q_positions=None,
                          kv_positions=None):
    """Launch ``flash_bwd_dkv`` (B3) on three-piece operands: (dK, dV)
    [B, Sk, Hk, D] float32, each summed over the G query heads of its
    group. Counts as ``flash_bwd_dq_x3_cuda``."""
    B, Sq, Sk, Hq, Hk, D = _check_pieces("flash_bwd_dkv_x3", qp, kp, vp,
                                         dop)
    _check_rowstats("flash_bwd_dkv_x3", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_bwd_dkv_x3", qp[0], kp[0],
                     (q_segment_ids, kv_segment_ids, q_positions,
                      kv_positions))
    out = _bwd_dkv("flash_bwd_dkv_x3", _BWD_PIECES, qp, kp, vp, dop, lse,
                   delta, causal, scale, seg, torch.float32)
    _simt_count(flash_bwd_dkv_x3_cuda, seg)
    return out


flash_bwd_dkv_x3_cuda.launches = 0
flash_bwd_dkv_x3_cuda.seg_launches = 0


def flash_split_bwd_cuda(q, k, v, o, lse, do, causal=False, scale=None,
                         q_segment_ids=None, kv_segment_ids=None,
                         q_positions=None, kv_positions=None, dlse=None,
                         dp=None):
    """The float32 backward on the tensor cores: Delta (from O and dO at
    their own head dim), then q, k, v and dO split into three bf16 pieces
    each with the head dim zero-padded to ``dp`` (64 or 128; default D),
    then B2 and B3. Returns float32 (dQ, dK, dV) at ``dp`` columns; give
    ``scale`` for the true head dim."""
    do = do.to(q.dtype)
    delta = flash_delta(o, do, dlse)
    pieces = [split_bf16x3_cuda(t if t.stride(-1) == 1 else t.contiguous(),
                                dp) for t in (q, k, v, do)]
    kw = dict(scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_positions=q_positions,
              kv_positions=kv_positions)
    dq = flash_bwd_dq_x3_cuda(*pieces, lse, delta, causal, **kw)
    dk, dv = flash_bwd_dkv_x3_cuda(*pieces, lse, delta, causal, **kw)
    return dq, dk, dv


def flash_bwd_cuda(q, k, v, o, lse, do, causal=False, scale=None,
                   q_segment_ids=None, kv_segment_ids=None, q_positions=None,
                   kv_positions=None, dlse=None):
    """The kernel route of the backward: Delta, then B2 and B3."""
    do = do.to(q.dtype)
    delta = flash_delta(o, do, dlse)
    kw = dict(scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_positions=q_positions,
              kv_positions=kv_positions)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, **kw)
    return dq, dk, dv


# -- float32 and fp16: flash_simt.cu -----------------------------------------

def _check_simt(what, q, k, v, extra=()):
    """Shapes, dtype and layout ``flash_simt.cu`` takes: 4-d float32 or
    fp16 CUDA tensors of one dtype with a unit innermost stride, any head
    dim and GQA group; returns (B, Sq, Sk, Hq, Hk, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if not t.is_cuda or t.dtype not in _SIMT_DTYPES or \
                t.dtype != q.dtype or t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"{what}: {name} must be a 4-d float32 or float16 CUDA "
                f"tensor of q's dtype with unit innermost stride, got "
                f"{t.dtype} on {t.device} with strides {tuple(t.stride())}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"shaped as q {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or \
            Hk <= 0 or Hq % Hk:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    return B, Sq, Sk, Hq, Hk, D


def _simt_count(fn, seg):
    if seg is None:
        fn.launches += 1
    else:
        fn.seg_launches += 1


def flash_simt_fwd_cuda(q, k, v, causal=False, scale=None,
                        q_segment_ids=None, kv_segment_ids=None,
                        q_positions=None, kv_positions=None):
    """Launch ``flash_simt_fwd``: (O, LSE) as ``flash_fwd_cuda`` returns
    them, for float32 or fp16 q/k/v (``_check_simt``) and segments as
    ``_check_seg`` takes them. Counts ``launches`` (dense) and
    ``seg_launches``. On no route since the tensor-core forward takes
    float32 and fp16 at every head dim; ``chip_smoke.py`` still times it
    and holds it against the plain forward."""
    B, Sq, Sk, Hq, Hk, D = _check_simt("flash_simt_fwd", q, k, v)
    seg = _check_seg("flash_simt_fwd", q, k, (q_segment_ids, kv_segment_ids,
                                             q_positions, kv_positions))
    out = torch.empty((B, Sq, Hq, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, Hq, Sq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_simt")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_simt_fwd(_SIMT_DTYPES[q.dtype], q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), *_seg_ptrs(seg), B, Sq, Sk, Hq,
                             Hk, D, int(bool(causal)), _scale(scale, D),
                             *_strides(q, k, v), stream)
    _build.check(err, "flash_simt_fwd")
    _simt_count(flash_simt_fwd_cuda, seg)
    return out, lse


flash_simt_fwd_cuda.launches = 0
flash_simt_fwd_cuda.seg_launches = 0


def flash_simt_dq_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                       q_segment_ids=None, kv_segment_ids=None,
                       q_positions=None, kv_positions=None):
    """Launch ``flash_simt_dq``: dQ [B, Sq, Hq, D] in q's dtype."""
    B, Sq, Sk, Hq, Hk, D = _check_simt("flash_simt_dq", q, k, v,
                                       (("do", do),))
    _check_rowstats("flash_simt_dq", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_simt_dq", q, k, (q_segment_ids, kv_segment_ids,
                                            q_positions, kv_positions))
    dq = torch.empty((B, Sq, Hq, D), device=q.device, dtype=q.dtype)
    lib = _build.load("flash_simt")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_simt_dq(
        _SIMT_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_seg_ptrs(seg), B, Sq, Sk, Hq, Hk, D, int(bool(causal)),
        _scale(scale, D), *_strides(q, k, v, do), stream)
    _build.check(err, "flash_simt_dq")
    _simt_count(flash_simt_dq_cuda, seg)
    return dq


flash_simt_dq_cuda.launches = 0
flash_simt_dq_cuda.seg_launches = 0


def flash_simt_dkv_cuda(q, k, v, do, lse, delta, causal=False, scale=None,
                        q_segment_ids=None, kv_segment_ids=None,
                        q_positions=None, kv_positions=None):
    """Launch ``flash_simt_dkv``: (dK, dV) [B, Sk, Hk, D] in k's dtype,
    each summed over the G query heads of its group."""
    B, Sq, Sk, Hq, Hk, D = _check_simt("flash_simt_dkv", q, k, v,
                                       (("do", do),))
    _check_rowstats("flash_simt_dkv", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    seg = _check_seg("flash_simt_dkv", q, k, (q_segment_ids, kv_segment_ids,
                                             q_positions, kv_positions))
    dk = torch.empty((B, Sk, Hk, D), device=q.device, dtype=k.dtype)
    dv = torch.empty((B, Sk, Hk, D), device=q.device, dtype=v.dtype)
    lib = _build.load("flash_simt")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_simt_dkv(
        _SIMT_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_seg_ptrs(seg), B, Sq, Sk, Hq, Hk, D,
        int(bool(causal)), _scale(scale, D), *_strides(q, k, v, do), stream)
    _build.check(err, "flash_simt_dkv")
    _simt_count(flash_simt_dkv_cuda, seg)
    return dk, dv


flash_simt_dkv_cuda.launches = 0
flash_simt_dkv_cuda.seg_launches = 0


def flash_simt_bwd_cuda(q, k, v, o, lse, do, causal=False, scale=None,
                        q_segment_ids=None, kv_segment_ids=None,
                        q_positions=None, kv_positions=None, dlse=None):
    """The backward on ``flash_simt.cu``: Delta, then dQ and dK/dV."""
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = flash_delta(o, do, dlse)
    kw = dict(scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids, q_positions=q_positions,
              kv_positions=kv_positions)
    dq = flash_simt_dq_cuda(q, k, v, do, lse, delta, causal, **kw)
    dk, dv = flash_simt_dkv_cuda(q, k, v, do, lse, delta, causal, **kw)
    return dq, dk, dv


# -- head-dim padding ---------------------------------------------------------

def kernel_head_dim(D):
    """True for the head dims the kernels are built for: 64, 128, 256 and
    every multiple of 128 above 256."""
    return D in _KERNEL_DIMS or (D > _KERNEL_DIMS[-1] and D % _WIDE_STEP == 0)


def padded_head_dim(D):
    """The head dim the kernels run a head dim D at: the smallest of
    ``_KERNEL_DIMS`` not below it up to 256 (65-128 run at 128, 129-256 at
    256), and above 256 the next multiple of 128, as the Pallas kernel pads
    D (288 runs at 384, 512 at 512, 640 at 640). Defined for every D >= 1."""
    for dp in _KERNEL_DIMS:
        if D <= dp:
            return dp
    return -(-D // _WIDE_STEP) * _WIDE_STEP


def pad_head_dim(t, dp):
    """``t`` [..., D] zero-padded to [..., dp] (``t`` itself when D ==
    dp). Zero columns of q and k add nothing to q . k and zero columns of
    v give zero columns of O, so the first D columns of every result and
    LSE are those of the unpadded inputs, at the scale of the true D
    (Pallas :793-802 pads and slices the same way)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


# -- routing and autograd ---------------------------------------------------

def _flash_mode(mode):
    """A ``FLAGS_flash_kernel`` value normalized; raises on an unknown
    value."""
    m = str(mode).strip().lower()
    if m not in _MODES:
        raise ValueError(f"FLAGS_flash_kernel must be one of {_MODES}, got "
                         f"{mode!r}")
    return m


def expand_factor(G):
    """The least r that divides the GQA group G and leaves G / r dividing
    64: K and V expanded r times along the head axis give the kernels a
    group they take (G 3 -> 3, G 12 -> 3, G 128 -> 2; 1 where G divides
    64)."""
    return next(r for r in range(1, G + 1)
                if G % r == 0 and _FOLD % (G // r) == 0)


def flash_route(device, dtype, Hq, Hk, D, mode):
    """Where ``FlashAttention``'s forward computes q [B, S, Hq, D] of
    ``dtype`` on ``device`` over Hk kv heads under ``FLAGS_flash_kernel``
    = ``mode``: ``cpu`` (CPU tensors: the plain pair), ``forced`` (mode
    ``plain``); float32 and fp16 on the tensor-core B1 at every head dim,
    fp16 as one f16 piece (``f16``), float32 as three bf16 pieces
    (``split``), D zero-padded to ``padded_head_dim`` and K, V expanded
    ``expand_factor(G)`` times where G does not divide 64; ``kernel`` (any
    other dtype, which the bf16 kernels refuse unless it is bf16, with G =
    Hq / Hk dividing 64 or Hq not a multiple of Hk) or ``expanded`` (bf16
    with any other G: K and V expanded ``expand_factor(G)`` times). Pure:
    decided before any launch from these alone."""
    mode = _flash_mode(mode)
    if torch.device(device).type == "cpu":
        return "cpu"
    if mode == "plain":
        return "forced"
    if dtype in _SIMT_DTYPES:
        return "split" if dtype == torch.float32 else "f16"
    if dtype != torch.bfloat16 or Hk <= 0 or Hq % Hk or \
            _FOLD % (Hq // Hk) == 0:
        return "kernel"
    return "expanded"


def flash_bwd_route(device, dtype, Hq, Hk, D, mode):
    """The backward's route, from the same arguments: the forward's
    (``flash_route``) but for float32 and fp16 above head dim 128, which
    B2 and B3 do not take: ``simt`` (``flash_simt.cu`` at the true D and
    group, on the forward's sliced O and its LSE). Pure, as
    ``flash_route``."""
    route = flash_route(device, dtype, Hq, Hk, D, mode)
    if route in ("f16", "split") and D > _TC_DIMS[-1]:
        return "simt"
    return route


def expand_kv(t, r):
    """``t`` [B, S, Hk, D] with each kv head repeated r times in place
    ([B, S, Hk r, D]): query head h of a group G / r then reads copy
    h // (G / r) of kv head h // G, the values it read before."""
    return t if r == 1 else t.repeat_interleave(r, dim=2)


def reduce_expanded(t, r, dtype):
    """The gradient of ``expand_kv``: the r copies' [B, S, Hk r, D]
    summed in float32 into [B, S, Hk, D], cast to ``dtype``."""
    if r == 1:
        return t
    return t.unflatten(2, (-1, r)).float().sum(3).to(dtype)


def _kernel_layout(t):
    """``t`` itself if the kernels can read it through its strides, else
    a contiguous copy (autograd may hand the backward an expanded or
    transposed dO; the forward's q/k/v views are always readable)."""
    ok = t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0
    return t if ok else t.contiguous()


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the custom VJP of the Pallas
    kernels). The forward runs B1 and saves (q, k, v, O, LSE) and the
    segment tensors; the backward computes Delta (less the LSE cotangent,
    when ``return_lse`` handed LSE out and it was used) and runs B2 and
    B3. Both routes are chosen in the forward, before any launch
    (``flash_route``, counted in ``ROUTE_COUNTS`` there;
    ``flash_bwd_route``, counted in ``BWD_ROUTE_COUNTS`` when the backward
    runs). On the kernel routes (``kernel``, ``expanded``, ``f16``,
    ``split``) any head dim the kernels are not built for is
    zero-padded to ``padded_head_dim`` (64, 128 or 256 up to 256, the next
    multiple of 128 above it) for each launch, at the true D's scale, and
    O, dQ, dK and dV are sliced back to D (``pad_head_dim``); on
    ``expanded``, ``f16`` and ``split`` K and V are also expanded r =
    ``expand_factor(G)`` times along the head axis (``expand_kv``; r is 1
    where G divides 64) for each launch, which leaves the forward exact,
    and the r copies' dK and dV are summed in float32
    (``reduce_expanded``). ``split`` splits q, k and v into three bf16
    pieces for the forward (``flash_split_fwd_cuda``) and splits them
    again, with dO, in the backward (``flash_split_bwd_cuda``): no pieces
    are held between the two. The backward's ``simt`` (float32 and fp16
    above head dim 128) runs ``flash_simt.cu`` at the true D and group on
    the unpadded q, k, v, the sliced O and LSE (computed at the true D's
    scale, so the same). On ``cpu`` and
    ``forced`` the forward runs ``flash_attention_plain`` (with autograd
    off, as inside every ``Function.forward``) and the backward
    ``flash_attention_bwd_plain``. The integer tensors get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale=None, q_segment_ids=None,
                kv_segment_ids=None, q_positions=None, kv_positions=None,
                return_lse=False):
        mode = _flags.flag("FLAGS_flash_kernel")
        shape = (q.shape[2], k.shape[2], q.shape[-1])
        route = flash_route(q.device, q.dtype, *shape, mode)
        bwd_route = flash_bwd_route(q.device, q.dtype, *shape, mode)
        ROUTE_COUNTS[route] += 1
        r = expand_factor(q.shape[2] // k.shape[2]) \
            if route in ("expanded", "f16", "split") else 1
        kw = dict(scale=scale, q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids, q_positions=q_positions,
                  kv_positions=kv_positions)
        if route in ("kernel", "expanded", "f16", "split"):
            D = q.shape[-1]
            dp = padded_head_dim(D)
            kw["scale"] = _scale(scale, D)
            ke, ve = expand_kv(k, r), expand_kv(v, r)
            if route == "split":
                o, lse = flash_split_fwd_cuda(q, ke, ve, causal, dp=dp, **kw)
            else:
                o, lse = flash_fwd_cuda(
                    *(pad_head_dim(t, dp) for t in (q, ke, ve)), causal,
                    **kw)
            if dp != D:
                o = o[..., :D].contiguous()
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse, q_segment_ids,
                              kv_segment_ids, q_positions, kv_positions)
        ctx.causal = bool(causal)
        ctx.scale = scale
        ctx.bwd_route = bwd_route
        ctx.expand = r
        ctx.set_materialize_grads(False)
        return (o, lse) if return_lse else o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse=None):
        q, k, v, o, lse, *seg = ctx.saved_tensors
        if do is None:  # only LSE was used
            do = torch.zeros_like(o)
        kw = dict(zip(_SEG_NAMES, seg), scale=ctx.scale, dlse=dlse)
        route = ctx.bwd_route
        BWD_ROUTE_COUNTS[route] += 1
        if route in ("kernel", "expanded", "f16", "split"):
            D = q.shape[-1]
            dp = padded_head_dim(D)
            r = ctx.expand
            kw["scale"] = _scale(ctx.scale, D)
            ke, ve = expand_kv(k, r), expand_kv(v, r)
            if route == "split":
                dq, dk, dv = flash_split_bwd_cuda(q, ke, ve, o, lse, do,
                                                  ctx.causal, dp=dp, **kw)
            else:
                dq, dk, dv = flash_bwd_cuda(
                    *(pad_head_dim(t, dp) for t in (q, ke, ve, o)), lse,
                    _kernel_layout(pad_head_dim(do, dp)), ctx.causal, **kw)
            if dp != D:
                dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
            dk = reduce_expanded(dk, r, k.dtype)
            dv = reduce_expanded(dv, r, v.dtype)
        elif route == "simt":
            dq, dk, dv = flash_simt_bwd_cuda(q, k, v, o, lse, do, ctx.causal,
                                             **kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   ctx.causal, **kw)
        return (dq, dk, dv) + (None,) * 7


def sdpa_masked_plain(q, k, v, attn_mask, causal=False, scale=None):
    """Attention with a mask, in plain PyTorch: the JAX package's
    ``sdpa_xla`` (``paddle_tpu/kernels/flash_attention.py:42``), which it
    computes instead of Pallas whenever a mask is given. q [B, Sq, Hq, D],
    k/v [B, Sk, Hk, D] (KV heads repeated for GQA); float32 logits at
    scale 1/sqrt(D); causal bottom-right; a bool mask (True = visible)
    becomes 0 / -inf, a float mask is added; softmax; P cast to q's dtype
    before P @ V. A row with every key masked is NaN, as there. Counts
    its calls in ``calls``: no path of the port that the kernels serve
    should reach it."""
    sdpa_masked_plain.calls += 1
    G = q.shape[2] // k.shape[2]
    if G != 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) \
        * _scale(scale, q.shape[-1])
    if causal:
        logits = logits.masked_fill(
            ~_valid_mask(q.shape[1], k.shape[1], True, q.device),
            float("-inf"))
    if attn_mask.dtype == torch.bool:
        bias = torch.zeros(attn_mask.shape, device=q.device).masked_fill(
            ~attn_mask, float("-inf"))
    else:
        bias = attn_mask.float()
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


sdpa_masked_plain.calls = 0


@op_hook("flash_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """SDPA on [batch, seq, heads, head_dim] with scale 1/sqrt(head_dim);
    key/value may have fewer heads (GQA). Without ``attn_mask`` it goes
    through ``FlashAttention``: CUDA tensors take the flash kernels, CPU
    tensors the plain pair; with no input requiring grad (serving)
    autograd records nothing. With ``attn_mask`` (bool, True = visible, or
    float, added to the logits; broadcastable against [B, H, Sq, Sk]) it
    computes ``sdpa_masked_plain``, as the JAX package leaves Pallas for
    ``sdpa_xla`` then. Dropout, as on the JAX package's route, drops
    entries of the attention output (upscaled by 1/(1-p)), so the kernels
    stay on the path when p > 0. Under ``amp.auto_cast`` q, k and v go to
    the AMP dtype first (the ``flash_attention`` entry of the white
    list)."""
    if _AMP.enabled:
        query, key, value = _amp_cast("flash_attention", query, key, value)
    if attn_mask is None:
        out = FlashAttention.apply(query, key, value, bool(is_causal))
    else:
        out = sdpa_masked_plain(query, key, value, attn_mask,
                                causal=is_causal)
    if training and dropout_p > 0.0:
        out = _dropout(out, dropout_p, training=True, generator=generator)
    return out


@op_hook("flash_attention")
def flash_attention(q, k, v, causal=False, scale=None, q_segment_ids=None,
                    kv_segment_ids=None, q_positions=None,
                    kv_positions=None, return_lse=False):
    """Flash attention on q [B, Sq, Hq, D], k/v [B, Sk, Hk, D] (Pallas
    :753): a caller's ``scale`` (default 1/sqrt(D)); with
    ``q_segment_ids`` (kv ids default to q's, positions to ``arange``) a
    query sees only keys of its own segment and, if causal, of a position
    not after its own. Differentiable in q, k, v (``FlashAttention``).
    Returns O [B, Sq, Hq, D] and, with ``return_lse``, LSE float32
    [B, Hq, Sq] (differentiable too). Under ``amp.auto_cast`` q, k and v
    go to the AMP dtype first."""
    if _AMP.enabled:
        q, k, v = _amp_cast("flash_attention", q, k, v)
    seg = _segments(q, k, q_segment_ids, kv_segment_ids, q_positions,
                    kv_positions) or (None,) * 4
    return FlashAttention.apply(q, k, v, bool(causal), scale, *seg,
                                bool(return_lse))


def _take(a, idx):
    """``a[idx]`` for a 1-d ``a`` as JAX gathers it: a negative index
    counts from the end, then an index out of range is clamped."""
    n = a.shape[0]
    return a[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def varlen_segments(cu_seqlens_q, cu_seqlens_k, tq, tk, device):
    """Segment ids and positions of packed sequences, exactly as Pallas
    :852-868 derives them: (seg_q, seg_k, rel_q, rel_k), int32 [tq] and
    [tk]. Token t of a side lies in sequence ``searchsorted(cu, t,
    side="right") - 1``; query positions are shifted by len_k - len_q so
    that a sequence's last query lines up with its last key (bottom-right
    causal), with len_k looked up at the query's sequence index clamped to
    the kv side's count."""
    cu_q = torch.as_tensor(cu_seqlens_q, device=device).to(torch.int64)
    cu_k = torch.as_tensor(cu_seqlens_k, device=device).to(torch.int64)
    pos_q = torch.arange(tq, device=device)
    pos_k = torch.arange(tk, device=device)
    seg_q = torch.searchsorted(cu_q, pos_q, right=True) - 1
    seg_k = torch.searchsorted(cu_k, pos_k, right=True) - 1
    len_q = _take(cu_q, seg_q + 1) - _take(cu_q, seg_q)
    last_k = cu_k.shape[0] - 1
    len_k_q = _take(cu_k, (seg_q + 1).clamp(max=last_k)) - \
        _take(cu_k, seg_q.clamp(max=last_k))
    rel_q = pos_q - _take(cu_q, seg_q) + (len_k_q - len_q)
    rel_k = pos_k - _take(cu_k, seg_k)
    return tuple(t.to(torch.int32) for t in (seg_q, seg_k, rel_q, rel_k))


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal=False,
                      scale=None):
    """Packed varlen attention (Pallas :836): q [Tq, Hq, D], k/v
    [Tk, Hk, D] with ``cu_seqlens_*`` [n + 1] prefix sums. Sequences attend
    only within themselves; causal masking uses positions inside the
    sequence, bottom-right aligned. Returns [Tq, Hq, D]."""
    seg_q, seg_k, rel_q, rel_k = varlen_segments(
        cu_seqlens_q, cu_seqlens_k, q.shape[0], k.shape[0], q.device)
    out = flash_attention(q[None], k[None], v[None], causal=causal,
                          scale=scale, q_segment_ids=seg_q[None],
                          kv_segment_ids=seg_k[None],
                          q_positions=rel_q[None], kv_positions=rel_k[None])
    return out[0]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Varlen flash attention on packed [total_tokens, heads, dim] inputs
    (``paddle_tpu/kernels/flash_attention.py:69``): ``flash_attn_varlen``,
    then, in training with ``dropout`` > 0, entries of the output dropped
    and the rest scaled by 1/(1 - dropout), the mask drawn from
    ``generator``; cast to q's dtype. Returns (out, None). ``max_seqlen_*``,
    ``return_softmax``, ``fixed_seed_offset`` and ``rng_name`` are
    accepted and unused, as there."""
    out = flash_attn_varlen(query, key, value, cu_seqlens_q, cu_seqlens_k,
                            causal=causal, scale=scale)
    if training and dropout > 0.0:
        out = _dropout(out, dropout, training=True, generator=generator)
    return out.to(query.dtype), None
