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
- ``prefill_plan`` picks the prefill kernel's token tile and split of K
  (M >= 9) so that every launch fills the card's SMs.
"""

from __future__ import annotations

import torch

from . import _build

SMS = 132         # streaming multiprocessors of an H100 SXM
TOK_TILE = 128    # tokens per CTA of the prefill kernel
CH_TILE = 256     # output channels per CTA of the prefill kernel
K_CHUNK = 64      # k per staged chunk
MIN_CHUNKS = 2    # least k chunks per split


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


def quant_matmul_plain(x, w_int8, w_scales):
    """``(x.float() @ (w.float() * s.float()[:, None]).T).to(x.dtype)``."""
    w = w_int8.float() * w_scales.float()[:, None]
    return (x.float() @ w.T).to(x.dtype)


def quant_matmul(x, w_int8, w_scales):
    """Launch ``quant_matmul_bf16`` for CUDA tensors: x bf16 [..., K]
    (contiguous), w_int8 int8 [N, K], w_scales float32 [N], all contiguous
    and 16-byte aligned, K a multiple of 16; returns bf16 [..., N]. Raises
    on anything else. Where ``prefill_plan`` splits K, the partial sums go
    to a float32 workspace [splits, M, N] allocated here."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_int8, w_scales)
    n, k = w_int8.shape
    for name, t, dt in (("x", x, torch.bfloat16), ("w_int8", w_int8,
                                                   torch.int8),
                        ("w_scales", w_scales, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"quant_matmul: {name} must be a contiguous, "
                             f"16-byte aligned {dt} CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
    if x.shape[-1] != k or k % 16 or tuple(w_scales.shape) != (n,):
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, w "
                         f"{(n, k)}, scales {tuple(w_scales.shape)}: K "
                         f"must match and be a multiple of 16")
    m = x.numel() // k
    out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=x.dtype)
    cps, splits = prefill_plan(m, n, k) if m > 8 else (1, 1)
    ws = torch.empty((splits, m, n), device=x.device,
                     dtype=torch.float32) if splits > 1 else None
    lib = _build.load("quant_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_bf16(x.data_ptr(), w_int8.data_ptr(),
                                w_scales.data_ptr(), out.data_ptr(),
                                None if ws is None else ws.data_ptr(), m,
                                n, k, cps, stream)
    _build.check(err, "quant_matmul_bf16")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
