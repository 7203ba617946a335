"""int8 weight matmul and its plain version (mirrors
``paddle_tpu/kernels/pallas/quant_matmul.py``).

y [..., N] = x [..., K] @ (w_int8 [N, K] * w_scales [N, 1]).T in
``x.dtype``, accumulating in float32. ``w_int8`` is [out, in]
(K-contiguous, PyTorch's ``Linear`` layout); the JAX package's is [in, out].

- ``quant_matmul`` launches ``csrc/quant_matmul.cu`` (Hopper counterpart
  of the Pallas ``_qmm_kernel``, :44 there) for CUDA tensors and takes the
  plain version for CPU tensors.
- ``quant_matmul_plain`` is the Pallas body's numerics: dequantize the
  weight to float32 (w * s), then a float32 product.
- ``quant_matmul_f16`` and ``quant_matmul_x3`` launch the same two
  kernels for fp16 x (products in fp16: int8 is exact in fp16 too) and
  float32 x (three bf16 pieces of x against the exact bf16 weight, three
  products summed in float32: at M >= 9 after the split pass
  ``split_bf16x3_cuda``, at M <= 8 split inside the kernel); y in x's
  dtype.
- All three take any K, as the reference's wrapper does (it pads M and N
  and takes K whole). With K a multiple of 16 the kernels load by TMA
  (decode) and 16-byte ``cp.async`` (prefill); otherwise an int8 weight
  row of K bytes has no 16-byte stride, and the same kernels load through
  a ragged loader (each weight row's 16-byte-aligned span by 16-byte
  ``cp.async``, read from the row's offset in it; x's rows at the widest
  granule they allow, zero-filled past K), counted apart in each
  wrapper's ``unaligned_launches``. Float32 x's pieces are then split
  with K padded to a multiple of 16.
- ``quant_matmul_simt`` launches ``csrc/quant_matmul_simt.cu`` (the CUDA
  cores, float32 sums, any K): the first kernel for K % 16 != 0, now on
  no route; ``chip_smoke.py`` still times it and holds it against the
  plain version.
- ``int8_linear`` is the routing point of ``quantization.
  ConvertedInt8Linear``: ``qmm_route`` decides from the mode, the device,
  x's dtype and K alone, before any launch, and ``ROUTE_COUNTS`` counts
  each decision.
- ``prefill_plan`` picks the prefill kernel's token tile and split of K
  (M >= 9) so that every launch fills the card's SMs.
- ``decode_plan`` picks the decode kernel's (M <= 8) split of K over a
  thread-block cluster; ``decode_shares`` is the k range of each rank of
  the cluster.
"""

from __future__ import annotations

import functools

import torch

from . import _build

SMS = 132         # streaming multiprocessors of an H100 SXM
TOK_TILE = 128    # tokens per CTA of the prefill kernel
CH_TILE = 256     # output channels per CTA of the prefill kernel
K_CHUNK = 64      # k per staged chunk
MIN_CHUNKS = 2    # least k chunks per split
# the decode kernel (M <= 8), mirrored from csrc/quant_matmul.cu (dec::)
DEC_MAX_M = 8            # token rows of x it stages
DEC_BK = 128             # k per ring stage
DEC_STAGES = 4           # ring depth
DEC_GRANULES = 8         # leaves of the fixed k tree
DEC_CLUSTERS = (1, 2, 4, 8)  # splits of K (portable cluster sizes)
DEC_CH = 64              # output channels per CTA (4 warps of 16)
SMEM_PER_BLOCK = 227 * 1024


def prefill_plan(m, n, k):
    """(k chunks per split, splits) of the prefill kernel (M >= 9) for
    x [m, k] and w [n, k]: K is split into the whole number of parts that
    brings the CTAs nearest one per SM (one part when the tiles alone
    reach that), with at least ``MIN_CHUNKS`` chunks a part."""
    ctas = -(-m // TOK_TILE) * -(-n // CH_TILE)
    chunks = -(-k // K_CHUNK)
    want = max(1, round(SMS / ctas))
    cps = max(-(-chunks // want), min(chunks, MIN_CHUNKS))
    return cps, -(-chunks // cps)


def decode_granule(k):
    """k per granule of the decode kernel's fixed sum tree: K / 8 rounded
    up to a whole number of 128-wide stages (the last granules may be
    short or empty)."""
    return -(-k // (DEC_GRANULES * DEC_BK)) * DEC_BK


def decode_shares(k, cluster):
    """The k range [k0, k1) of each of the ``cluster`` ranks splitting K:
    rank r holds granules [8 r / C, 8 (r + 1) / C); a range may be empty."""
    span = DEC_GRANULES // cluster * decode_granule(k)
    return [(min(r * span, k), min((r + 1) * span, k))
            for r in range(cluster)]


def decode_smem_bytes(cluster, x_bytes=2):
    """Dynamic shared memory of one decode CTA: the ring (each stage x's 8
    rows over 128 k, of ``x_bytes`` an element, and the CTA's 64 weight
    rows), with a cluster the owner slots (one float4 a lane of each owned
    warp, from each rank), and the ring's full and empty barriers."""
    warps = DEC_CH // 16
    slots = -(-warps // cluster) * cluster * 32 * 16 if cluster > 1 else 0
    return DEC_STAGES * (DEC_MAX_M * x_bytes * DEC_BK + DEC_CH * DEC_BK) \
        + slots + 2 * DEC_STAGES * 8


@functools.lru_cache(maxsize=256)
def decode_plan(m, n, k, cluster=None):
    """Cluster size of the decode kernel (M <= 8) for x [m, k] and w [n, k]
    (m, 1 to 8, does not change it). A CTA owns ``DEC_CH`` channels; a
    cluster of C CTAs splits K (``decode_shares``): the smallest C whose
    grid, ceil(n / 64) x C CTAs, reaches one CTA per SM, else the largest,
    never one with a rank that holds none of K. ``cluster`` forces C (a
    forced cluster may leave a rank with none of K). Raises ``ValueError``
    for a size the kernel does not take."""
    if cluster is not None and cluster not in DEC_CLUSTERS:
        raise ValueError(f"decode_plan: cluster {cluster} not in "
                         f"{DEC_CLUSTERS}")
    if cluster is None:
        tiles = -(-n // DEC_CH)
        sizes = [c for c in DEC_CLUSTERS if decode_shares(k, c)[-1][0] < k]
        cluster = next((c for c in sizes if tiles * c >= SMS), sizes[-1])
    return cluster


def quant_matmul_plain(x, w_int8, w_scales):
    """``(x.float() @ (w.float() * s.float()[:, None]).T).to(x.dtype)``."""
    w = w_int8.float() * w_scales.float()[:, None]
    return (x.float() @ w.T).to(x.dtype)


# ``int8_linear``'s routing decisions (``qmm_route``), one a call:
# ``kernel`` (``quant_matmul``: bf16 x), ``f16`` (``quant_matmul_f16``),
# ``split`` (``quant_matmul_x3``: float32 x), each with K a multiple of 16,
# and their ``unaligned``, ``f16_unaligned`` and ``split_unaligned`` forms
# (the same wrappers through the ragged loader: any other K), ``cpu`` (CPU
# tensors: the plain version) and ``dense`` (FLAGS_paged_kernel=dense
# forces the plain version)
ROUTE_COUNTS = {"kernel": 0, "f16": 0, "split": 0, "unaligned": 0,
                "f16_unaligned": 0, "split_unaligned": 0, "cpu": 0,
                "dense": 0}
# x dtypes ``quant_matmul_simt`` takes, by their code in its C entry point
_SIMT_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the tensor-core routes by x's dtype, and their codes in the C entry
# points ``quant_matmul_tc`` / ``quant_matmul_decode_tc``
_TC_ROUTES = {torch.bfloat16: "kernel", torch.float16: "f16",
              torch.float32: "split"}
_TC_CODES = {torch.float16: 1, torch.float32: 2}
# the k granule the tensor-core kernels' aligned loaders need
K_ALIGN = 16


def qmm_route(mode, device_type, x_dtype, k):
    """The route of an int8 linear layer's product from its resolved
    ``FLAGS_paged_kernel`` mode, x's device type and dtype and the
    contraction K: ``dense`` (forced: the plain version), ``cpu`` (the
    plain version); on the card ``kernel`` (bf16 x, and any x dtype the
    kernels refuse), ``f16`` (fp16 x) or ``split`` (float32 x) with K a
    multiple of 16, else their ``*unaligned`` forms (an int8 weight row of
    K bytes then has no 16-byte stride for TMA or 16-byte cp.async: the
    same kernels through the ragged loader). Pure: decided before any
    launch."""
    if mode == "dense":
        return "dense"
    if device_type == "cpu":
        return "cpu"
    route = _TC_ROUTES.get(x_dtype, "kernel")
    if k % K_ALIGN == 0:
        return route
    return "unaligned" if route == "kernel" else f"{route}_unaligned"


def int8_linear(x, w_int8, w_scales, mode):
    """x [..., K] @ (w_int8 [N, K] * w_scales [N]).T in x's dtype, on the
    route ``qmm_route`` picks (counted in ``ROUTE_COUNTS``)."""
    route = qmm_route(mode, x.device.type, x.dtype, w_int8.shape[1])
    ROUTE_COUNTS[route] += 1
    if route in ("kernel", "unaligned"):
        return quant_matmul(x, w_int8, w_scales)
    if route in ("f16", "f16_unaligned"):
        return quant_matmul_f16(x, w_int8, w_scales)
    if route in ("split", "split_unaligned"):
        return quant_matmul_x3(x, w_int8, w_scales)
    return quant_matmul_plain(x, w_int8, w_scales)


def quant_matmul_simt(x, w_int8, w_scales):
    """Launch ``csrc/quant_matmul_simt.cu`` for CUDA tensors: x [..., K]
    float32, fp16 or bf16 (made contiguous here), any K; w_int8 int8
    [N, K] and w_scales float32 [N], contiguous. Returns [..., N] in x's
    dtype; raises on anything else. CPU tensors take the plain version.
    Counts ``launches``. On no route (``int8_linear`` sends every K to
    the tensor-core kernels)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int8, w_scales)
    n, k = w_int8.shape
    if x.dtype not in _SIMT_DTYPES or not x.is_cuda:
        raise ValueError(f"quant_matmul_simt: x must be a float32, float16 "
                         f"or bfloat16 CUDA tensor, got {x.dtype} on "
                         f"{x.device}")
    for name, t, dt in (("w_int8", w_int8, torch.int8),
                        ("w_scales", w_scales, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"quant_matmul_simt: {name} must be a "
                             f"contiguous {dt} CUDA tensor, got {t.dtype} "
                             f"on {t.device}")
    if x.shape[-1] != k or tuple(w_scales.shape) != (n,):
        raise ValueError(f"quant_matmul_simt: x {tuple(x.shape)}, w "
                         f"{(n, k)}, scales {tuple(w_scales.shape)}")
    x2 = x.reshape(-1, k).contiguous()
    out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
    if x2.shape[0] == 0:
        return out
    lib = _build.load("quant_matmul_simt")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_simt(_SIMT_DTYPES[x.dtype], x2.data_ptr(),
                                w_int8.data_ptr(), w_scales.data_ptr(),
                                out.data_ptr(), x2.shape[0], n, k, stream)
    _build.check(err, "quant_matmul_simt")
    quant_matmul_simt.launches += 1
    return out


quant_matmul_simt.launches = 0


def _check_tc(what, x, w_int8, w_scales, dtype):
    """The operands the tensor-core kernels take: x ``dtype`` [..., K],
    w_int8 int8 [N, K], w_scales float32 [N], all contiguous and on the
    card, w_scales 16-byte aligned; x and w_int8 too where K is a multiple
    of 16 (any other K takes the ragged loader, which copies at the widest
    granule the rows and bases allow). Returns (M, N, K)."""
    n, k = w_int8.shape
    aligned = k % K_ALIGN == 0
    for name, t, dt in (("x", x, dtype), ("w_int8", w_int8, torch.int8),
                        ("w_scales", w_scales, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() or \
                (t.data_ptr() % 16 and (aligned or name == "w_scales")):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dt} CUDA tensor (16-byte aligned where K "
                             f"is a multiple of 16, w_scales always), got "
                             f"{t.dtype} on {t.device}")
    if x.shape[-1] != k or tuple(w_scales.shape) != (n,):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w "
                         f"{(n, k)}, scales {tuple(w_scales.shape)}: K "
                         f"must match")
    return x.numel() // k, n, k


def _launch_tc(x, xk, w_int8, w_scales, m, n, k, code, ldx=None):
    """One launch of the decode kernel (m <= 8, on ``x``) or the prefill
    kernel (on ``xk``: x itself, or float32 x's pieces, ``ldx`` elements a
    row: K unless padded) for element code ``code`` (None: bf16), through
    the ragged loader where K is not a multiple of 16; the prefill's split
    sums go to a float32 workspace [splits, M, N] allocated here. Returns
    y in x's dtype."""
    out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
    if m == 0:
        return out
    lib = _build.load("quant_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = k % K_ALIGN == 0
    if m <= DEC_MAX_M:
        args = (x.data_ptr(), w_int8.data_ptr(), w_scales.data_ptr(),
                out.data_ptr(), m, n, k, decode_plan(m, n, k), stream)
        if not aligned:  # the ragged loader's entries take bf16 as code 0
            err, what = lib.quant_matmul_decode_unaligned(
                code or 0, *args), "quant_matmul_decode_unaligned"
        elif code is None:
            err, what = lib.quant_matmul_decode_bf16(*args), \
                "quant_matmul_decode_bf16"
        else:
            err, what = lib.quant_matmul_decode_tc(code, *args), \
                "quant_matmul_decode_tc"
    else:
        cps, splits = prefill_plan(m, n, k)
        ws = torch.empty((splits, m, n), device=x.device,
                         dtype=torch.float32) if splits > 1 else None
        args = (xk.data_ptr(), w_int8.data_ptr(), w_scales.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), m, n,
                k, cps, stream)
        if not aligned:
            err, what = lib.quant_matmul_unaligned(
                code or 0, *args[:-2], k if ldx is None else ldx,
                cps, stream), "quant_matmul_unaligned"
        elif code is None:
            err, what = lib.quant_matmul_bf16(*args), "quant_matmul_bf16"
        else:
            err, what = lib.quant_matmul_tc(code, *args), "quant_matmul_tc"
    _build.check(err, what)
    return out


def _count(fn, m, k):
    """One launch of ``fn`` (none at M 0): ``launches``, or with K not a
    multiple of 16 (the ragged loader) ``unaligned_launches``."""
    if m:
        if k % K_ALIGN:
            fn.unaligned_launches += 1
        else:
            fn.launches += 1


def quant_matmul(x, w_int8, w_scales):
    """Launch ``csrc/quant_matmul.cu`` for CUDA tensors: x bf16 [..., K]
    (contiguous), w_int8 int8 [N, K], w_scales float32 [N], all contiguous
    (x and w_int8 16-byte aligned where K is a multiple of 16, w_scales
    always), any K; returns bf16 [..., N]. Raises on anything else. M =
    x's rows: up to 8, one launch of the decode kernel as ``decode_plan``
    says (no workspace); from 9, the prefill kernel, and where
    ``prefill_plan`` splits K, the partial sums go to a float32 workspace
    [splits, M, N] allocated here. Counts as ``_count`` says."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int8, w_scales)
    m, n, k = _check_tc("quant_matmul", x, w_int8, w_scales, torch.bfloat16)
    out = _launch_tc(x, x, w_int8, w_scales, m, n, k, None)
    _count(quant_matmul, m, k)
    return out


quant_matmul.launches = 0
quant_matmul.unaligned_launches = 0


def quant_matmul_f16(x, w_int8, w_scales):
    """``quant_matmul`` for fp16 x: the same two kernels with their
    products in fp16 (each int8 weight is exact in fp16), summed in
    float32, y fp16. Counts ``launches``."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int8, w_scales)
    m, n, k = _check_tc("quant_matmul_f16", x, w_int8, w_scales,
                        torch.float16)
    out = _launch_tc(x, x, w_int8, w_scales, m, n, k, _TC_CODES[x.dtype])
    _count(quant_matmul_f16, m, k)
    return out


quant_matmul_f16.launches = 0
quant_matmul_f16.unaligned_launches = 0


def quant_matmul_x3(x, w_int8, w_scales):
    """``quant_matmul`` for float32 x: x as three bf16 pieces (x0 + x1 +
    x2 == x, ``split_bf16x3_plain``'s rule) times the exact bf16 weight,
    the three products summed in float32 and scaled once, y float32. At
    M >= 9 the split pass (``split_bf16x3_cuda``, counted there) writes the
    pieces [3, M, K] first (K zero-padded to a multiple of 16 where it is
    not one, so that only w's rows are unaligned); at M <= 8 the decode
    kernel splits x as it takes its fragments (one launch). Counts as
    ``_count`` says (this kernel's launches, not the split pass's)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int8, w_scales)
    m, n, k = _check_tc("quant_matmul_x3", x, w_int8, w_scales,
                        torch.float32)
    xk, ldx = x, k
    if m > DEC_MAX_M:
        from .flash_attention import split_bf16x3_cuda
        ldx = -(-k // K_ALIGN) * K_ALIGN
        xk = split_bf16x3_cuda(x.view(1, m, 1, k), ldx)
    out = _launch_tc(x, xk, w_int8, w_scales, m, n, k, _TC_CODES[x.dtype],
                     ldx)
    _count(quant_matmul_x3, m, k)
    return out


quant_matmul_x3.launches = 0
quant_matmul_x3.unaligned_launches = 0
