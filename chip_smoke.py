#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``paddle_tpu_torch/kernels/csrc`` with nvcc, one process
   per source, all at once.
2. Kernel phases, in bf16: each kernel's wrapper against its plain PyTorch
   version on the same inputs, within a stated tolerance; its time (CUDA
   events, median of 30 launches), the plain version's time, one PyTorch
   library call's time as a yardstick, and its bound (bytes at 3.35 TB/s
   or flops at 989 TFLOP/s, whichever is larger, from this run's inputs).
   B1 and B7's prefill path are also timed as CUDA-graph replays, kernel
   and library alike (no host launch overhead).
   The flash forward (B1) runs at Llama-3-8B's serving shapes (Hq 32, Hk 8,
   D 128) and at GPT-2 medium's (B 8, S 1024, H 16, D 64), held per query
   row too and shown to fail without its last key tile; the flash
   backward kernels (B2 dQ, B3 dK/dV) at GPT-2 medium's and at Llama-3-8B's
   (B 1, S 2048, Hq 32, Hk 8, D 128); the paged-decode kernels at the
   serving path's, over bf16 pools (B4, B6) and int8 pools (B5, B6q); the
   int8 weight matmul (B7) at decode (M 8) for each of Llama-3-8B's five
   projection shapes and at the longest prefill (M 1008) for each of the
   four layer shapes (and gate/up at the shortest, M 112), with its sums
   over one decode step's 225 launches and one prefill's 224 layer
   launches against their bounds.
3. Serving phase: Llama-3-8B at full width and depth, bf16, random weights
   from a fixed generator, served by ``ContinuousBatchingEngine``:
   engine A (max_seq_len 2048: the split-KV decode route) and engine B
   (max_seq_len 240: the per-page route), then a profile of A's decode.
   Then the same model is converted in place to int8 weights by the port's
   ``QAT`` and served with an int8 KV cache by engines A8 and B8 (A's and
   B's prompts, routes and token counts), and A8's decode is profiled.
   One 1000-token prefill (padded to 1008) of A's and of A8's model is
   timed and profiled by kernel group.
   Each engine's kernel launch counts are zeroed before it runs and must
   move by exactly the expected amounts; a teacher-forced dense forward of
   the model as served (bf16, or int8 weights through B7's plain version
   and attention over int8-rounded K/V for the decoded positions) must
   agree with every generated token whose top-2 logit gap exceeds the bf16
   tolerance.
4. Training phase: GPT-2 medium at full width and depth (24 layers, hidden
   1024, batch 8 x 1024), bf16 parameters with fp32 masters, AdamW 3e-4,
   global-norm clip 1.0, driven by ``TrainStep`` on one fixed batch. A
   gate holds one forward + backward on the kernel route against the plain
   route (``FLAGS_flash_kernel=plain``); then 2 warm-up and 10 timed steps
   (counts zeroed before, read after: B1, B2 and B3 must move by 24 per
   step; the loss must stay finite and fall), and a profile of 2 steps.
5. Prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": ...}`` line. Any failure exits non-zero before
   it. Without a GPU, or without the package beside this file, it exits 2.

Before the ``kernels`` line it prints the run's full record (every phase,
every engine, the training run, the profiles) as one ``record {...}`` JSON
line.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor core peak
HQ, HK, D = 32, 8, 128        # Llama-3-8B attention shapes
LAYERS = 32
DEVICE = "cuda"
# bf16 tolerances (absolute). Outputs are convex combinations of V rows
# drawn N(0, 1), so |O| stays below ~4, where one bf16 ulp is 2^-6; the
# kernel rounds P (unnormalized) and the plain version rounds P
# (normalized), which moves O by a few ulps at most.
O_ATOL = 3e-2
LSE_ATOL = 2e-3
# flash forward (B1): also per (batch, position, head) row, max |kernel -
# plain| / max |plain| of the row within ROW_RTOL. A late row's |O| at
# S 1024 is ~0.03-0.1, as small as O_ATOL; 2e-2 is two and a half bf16
# ulps at the row's largest value (DECODE_RTOL's reasoning). Each flash
# phase proves that the check sees a fault: the plain version with the
# last 64-key tile of the last query block left out must fail it, and the
# LSE check too.
ROW_RTOL = 2e-2
FLASH_ROWS = 64               # folded (position, head) rows per B1 CTA
FLASH_KEYS = 64               # keys per B1 tile
# paged decode (B4-B6q): within O_ATOL, and per slot max |kernel - plain|
# / max |plain| within DECODE_RTOL. A slot's |O| falls as its length grows
# (~0.15 at 2048 tokens against ~3 at 1), so the absolute limit is loose
# for long slots. One bf16 ulp is at most 2^-7 of the value it rounds, so
# 2e-2 allows two and a half ulps at the slot's largest value; a slot
# missing one staged chunk of keys moves by ~0.3 of it, and the phase
# checks that on every run.
DECODE_RTOL = 2e-2
# backward kernels: max |kernel - plain| / max |plain| (dK and dV sum over
# the sequence; P and dS round to bf16 at slightly different points)
BWD_RTOL = 2e-2
# GPT-2 medium, the training phase's shapes
GPT_B, GPT_S, GPT_H, GPT_D, GPT_LAYERS = 8, 1024, 16, 64, 24
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 2
# kernel route vs plain route, one forward + backward of GPT-2 medium in
# bf16: the two differ only in rounding inside attention
GATE_LOSS_RTOL = 1e-2
GATE_NORM_RTOL = 2e-2
GATE_MIN_COSINE = 0.99
# teacher-forced check: positions whose top-2 logit gap is below this are
# too close to call in bf16 and are skipped
GAP_TOL = 0.25
MIN_CHECKED_SHARE = 0.10
# int8 weight matmul (B7): max |kernel - plain| / max |plain|. The kernel
# multiplies the channel scale after the f32 sum, the plain version before
# it; the two differ by f32 rounding, then by one bf16 rounding of y.
QMM_RTOL = 1e-2
# Llama-3-8B's converted layers at decode (M = 8 slot rows): (N, K) and
# launches per decode step. The first is the kernel's record shape.
QMM_DECODE = (((14336, 4096), 64),   # gate_proj, up_proj x 32 layers
              ((4096, 4096), 64),    # q_proj, o_proj
              ((1024, 4096), 64),    # k_proj, v_proj
              ((4096, 14336), 32),   # down_proj
              ((128256, 4096), 1))   # lm_head
QMM_PREFILL_M = 1008                 # the longest padded prompt
QMM_SHORT_M = 112                    # the shortest padded prompt of A8
# the converted layers at prefill (M = the padded prompt) and launches
# per prefill; the LM head runs on the last position only (M 1, decode's
# kernel). Gate/up first: the kernel's prefill record shape.
QMM_PREFILL = QMM_DECODE[:4]
QMM_PER_FORWARD = 7 * LAYERS + 1     # B7 launches per prefill or decode step
PREFILL_PROFILE_LEN = 1000           # one prompt, padded to 1008


def fail(msg, code=1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median per-launch time with CUDA events; optionally evicts the
    50 MB L2 before each launch (decode reads a cold cache per layer) by
    reading a 64 MB buffer, which leaves the L2 full of clean lines, as the
    serving path does (it reads weights and writes little)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)

    def graph(self, fn, iters=30, cold=False):
        """Median time of one replay of ``fn`` captured in a CUDA graph:
        the device's time for the call without the host's launch overhead
        (a Python wrapper's checks and ctypes call can outlast a short
        kernel, and the event timer then measures the host)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        ms = self(g.replay, iters=iters, cold=cold)
        del g
        return ms

    def __call__(self, fn, iters=30, warmup=3, cold=False):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            if cold:
                self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))


def sdpa_library(torch, q, k, v, **kw):
    """One PyTorch SDPA call on [B, H, S, D] views (the yardstick; the port
    never calls it). Uses enable_gqa where this torch has it, else
    expands KV once, outside the timed call."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        ke = k.repeat_interleave(g, dim=1)
        ve = v.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def row_rel_err(out, ref):
    """Per (batch, position, head) row: max |out - ref| / max |ref|. A
    row with no visible key has ref == 0: a zero output there reads 0, any
    other output a huge error (non-finite outputs are checked apart)."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


def dropped_tile(q, k, v, o_ref, lse_ref):
    """The plain version (causal, Sq == Sk) with the last 64-key tile of
    the last query block left out: the block's positions at or past that
    tile's first key see only the keys before it."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain)
    S = q.shape[1]
    bq = FLASH_ROWS // (q.shape[2] // k.shape[2])
    t_last = (S - 1) // FLASH_KEYS * FLASH_KEYS
    p0 = max((S - 1) // bq * bq, t_last)
    o, lse = o_ref.clone(), lse_ref.clone()
    o[:, p0:], lse[:, :, p0:] = flash_attention_plain(
        q[:, p0:], k[:, :t_last], v[:, :t_last], causal=False,
        return_lse=True)
    return o, lse


def flash_phase(torch, timer, S, B=1, hq=HQ, hk=HK, dh=D):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_fwd_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(1000 + S + dh)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    q, k, v = mk(hq), mk(hk), mk(hk)
    o, lse = flash_fwd_cuda(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    o_cut, lse_cut = dropped_tile(q, k, v, o_ref, lse_ref)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    err_row = row_rel_err(o, o_ref)
    cut_row = row_rel_err(o_cut, o_ref)
    cut_l = (lse_cut - lse_ref).abs().max().item()
    del o_cut, lse_cut
    ok = err_o <= O_ATOL and err_l <= LSE_ATOL and err_row <= ROW_RTOL \
        and bool(torch.isfinite(o.float()).all())
    if cut_row <= ROW_RTOL or cut_l <= LSE_ATOL:
        fail(f"flash_fwd S={S}: the check cannot see a missing key tile "
             f"(row {cut_row} <= {ROW_RTOL} or LSE {cut_l} <= {LSE_ATOL})")
    ms = timer(lambda: flash_fwd_cuda(q, k, v, causal=True))
    graph_ms = timer.graph(lambda: flash_fwd_cuda(q, k, v, causal=True))
    plain_ms = timer(lambda: flash_attention_plain(q, k, v, causal=True,
                                                   return_lse=True))
    lib = sdpa_library(torch, q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), is_causal=True)
    library_ms = timer(lib)
    library_graph_ms = timer.graph(lib)
    pairs = S * (S + 1) // 2
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * 2 \
        + lse.numel() * 4
    bms, by = bound(nbytes, 4 * B * hq * dh * pairs)
    rec = dict(B=B, S=S, Hq=hq, Hk=hk, D=dh, max_abs_err=err_o,
               lse_err=err_l, row_rel_err=err_row,
               missing_tile_row_rel_err=cut_row, missing_tile_lse_err=cut_l,
               ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_graph_ms=library_graph_ms,
               bound_ms=bms, bound_by=by, ok=ok)
    print(f"flash_fwd B={B} S={S} Hq={hq} Hk={hk} D={dh}: err O "
          f"{err_o:.3e} LSE {err_l:.3e} row {err_row:.3e} (a key tile "
          f"missing: row {cut_row:.3e} LSE {cut_l:.3e}) | kernel {ms:.4f} "
          f"ms (graph {graph_ms:.4f}) plain {plain_ms:.4f} ms sdpa "
          f"{library_ms:.4f} ms (graph {library_graph_ms:.4f}) bound "
          f"{bms:.4f} ms ({by})", flush=True)
    if not ok:
        fail(f"flash_fwd disagrees with its plain version at S={S}: "
             f"O {err_o} (atol {O_ATOL}), LSE {err_l} (atol {LSE_ATOL}), "
             f"row {err_row} (rtol {ROW_RTOL})")
    return rec


def sdpa_backward_library(torch, q, k, v, do):
    """The backward of one PyTorch SDPA call (causal) on [B, H, S, D]
    views, through ``torch.autograd.grad``: the yardstick for B2 + B3
    together (the port never calls it). KV is expanded for GQA where this
    torch has no ``enable_gqa``."""
    F = torch.nn.functional
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        out = F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1),
            is_causal=True)
    return lambda: torch.autograd.grad(out, (q, k, v), do,
                                       retain_graph=True)


def flash_bwd_phase(torch, timer, B, S, hq, hk, dh):
    """B2 and B3 against ``flash_attention_bwd_plain`` (causal), with the
    forward's O and LSE from B1. Returns one record per kernel."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_delta, flash_fwd_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(2000 + S + dh)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    o, lse = flash_fwd_cuda(q, k, v, causal=True)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    errs = {}
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        diff = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        errs[name] = (diff, diff / max(scale, 1e-6),
                      bool(torch.isfinite(out.float()).all()))
    del refs
    dq_ms = timer(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                            causal=True))
    dkv_ms = timer(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal=True))
    plain_ms = timer(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       causal=True),
                     iters=20)
    lib = sdpa_backward_library(torch, q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), do.transpose(1, 2))
    library_ms = timer(lib, iters=20)
    pairs = S * (S + 1) // 2
    flop = 2 * B * hq * dh * pairs
    qb = q.numel() * 2
    kvb = k.numel() * 2
    rows = lse.numel() * 4 * 2  # LSE and Delta
    shape = dict(B=B, S=S, Hq=hq, Hk=hk, D=dh)
    recs = {}
    for name, ms, n_products, nbytes, keys in (
            ("flash_bwd_dq", dq_ms, 3, 3 * qb + 2 * kvb + rows, ("dq",)),
            ("flash_bwd_dkv", dkv_ms, 4, 2 * qb + 4 * kvb + rows,
             ("dk", "dv"))):
        bms, by = bound(nbytes, n_products * flop)
        abs_err = max(errs[k][0] for k in keys)
        rel_err = max(errs[k][1] for k in keys)
        ok = rel_err <= BWD_RTOL and all(errs[k][2] for k in keys)
        recs[name] = dict(shape, max_abs_err=abs_err, rel_err=rel_err,
                          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bms, bound_by=by, ok=ok)
        print(f"{name} B={B} S={S} Hq={hq} Hk={hk} D={dh}: err "
              f"{abs_err:.3e} (rel {rel_err:.3e}) | kernel {ms:.4f} ms "
              f"plain (whole backward) {plain_ms:.4f} ms sdpa backward "
              f"{library_ms:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        if not ok:
            fail(f"{name} disagrees with flash_attention_bwd_plain at "
                 f"S={S} D={dh}: relative error {rel_err} (limit "
                 f"{BWD_RTOL})")
    return recs


def decode_inputs(torch, B, mbps, lens, seed, bs=16):
    rng = np.random.RandomState(seed)
    nb = B * mbps + 1
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=DEVICE,
                                dtype=torch.bfloat16)
    kp, vp = mk(nb, bs, HK, D), mk(nb, bs, HK, D)
    q = mk(B, HQ, D)
    tbl = np.zeros((B, mbps), np.int32)
    for i in range(B):
        need = -(-int(lens[i]) // bs)
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:need]  # scattered blocks
    return (q, kp, vp, torch.as_tensor(tbl, device=DEVICE),
            torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE))


def slot_rel_err(out, ref):
    """Per slot: max |out - ref| / max |ref|. A slot with no keys has
    ref == 0: a zero output there reads 0, any other output a huge error
    (non-finite outputs are checked apart)."""
    diff = (out.float() - ref.float()).flatten(1).abs().amax(1)
    scale = ref.float().flatten(1).abs().amax(1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


def decode_phase(torch, timer, name, wrapper, B, mbps, lens, seed,
                 quantized=False, drop_pages=1):
    """One paged-decode kernel against ``paged_decode_attention_dense``;
    with ``quantized`` the pools are int8 rows with float32 scales
    (``quantize_rows`` of the same bf16 pools), and the library yardstick
    is SDPA over the gathered KV dequantized outside the timed call. The
    check must see ``drop_pages`` pages (one staged chunk of the split
    kernel) go missing: the plain version over the longest slot cut short
    by that many pages has to fail it."""
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_dense)
    from paddle_tpu_torch.quantization import quantize_rows
    q, kp, vp, tbl, sl = decode_inputs(torch, B, mbps, lens, seed)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    out = wrapper(q, kp, vp, tbl, sl, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    cut = sl.clone()
    cut[int(np.argmax(lens))] -= drop_pages * kp.shape[1]
    missing = slot_rel_err(
        paged_decode_attention_dense(q, kp, vp, tbl, cut, **scales), ref)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = slot_rel_err(out, ref)
    ok = rel <= DECODE_RTOL and err <= O_ATOL and \
        bool(torch.isfinite(out.float()).all())
    if missing <= DECODE_RTOL:
        fail(f"{name}: the check cannot see {drop_pages} missing pages "
             f"({missing} <= {DECODE_RTOL})")
    ms = timer(lambda: wrapper(q, kp, vp, tbl, sl, **scales), cold=True)
    plain_ms = timer(lambda: paged_decode_attention_dense(
        q, kp, vp, tbl, sl, **scales), cold=True)
    bs = kp.shape[1]
    idx = tbl.long()

    def gathered(pool, scale):
        g = pool[idx]
        if scale is not None:
            g = (g.float() * scale[idx][..., None]).to(torch.bfloat16)
        return g.reshape(B, mbps * bs, HK, D).transpose(1, 2)

    kg = gathered(kp, scales.get("k_scale"))
    vg = gathered(vp, scales.get("v_scale"))
    mask = (torch.arange(mbps * bs, device=DEVICE)[None, :]
            < sl[:, None])[:, None, None, :]
    lib = sdpa_library(torch, q[:, :, None, :], kg, vg, attn_mask=mask)
    library_ms = timer(lib, cold=True)
    total = int(np.sum(lens))
    row_bytes = D + 4 if quantized else D * 2  # int8 row + its f32 scale
    nbytes = 2 * q.numel() * 2 + total * HK * row_bytes * 2 \
        + tbl.numel() * 4 + sl.numel() * 4
    bms, by = bound(nbytes, 4 * HQ * D * total)
    rec = dict(B=B, mbps=mbps, lens=[int(x) for x in lens],
               pools="int8" if quantized else "bf16", max_abs_err=err,
               slot_rel_err=rel, missing_pages=drop_pages,
               missing_pages_rel_err=missing, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bms, bound_by=by, ok=ok)
    print(f"{name} B={B} pages={mbps} lens={list(map(int, lens))} "
          f"pools={rec['pools']}: err {err:.3e} (slot rel {rel:.3e}; "
          f"{drop_pages} pages missing: {missing:.3e}) | kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
          f"{bms:.4f} ms ({by})", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version: slot relative "
             f"error {rel} (limit {DECODE_RTOL}), absolute {err} (limit "
             f"{O_ATOL})")
    return rec


def qmm_phase(torch, timer, M, N, K, seed):
    """B7 against ``quant_matmul_plain`` on x [M, K] bf16 and a weight
    [N, K] quantized by the port's own ``_quantize_weight`` (bf16 scales,
    handed to the kernel in float32, as ``ConvertedInt8Linear`` does).
    Error: max |kernel - plain| / max |plain|. Library yardstick:
    ``F.linear`` on a bf16 copy of w * s made outside the timed call -- the
    same product, reading twice the weight bytes. Cold L2: at decode every
    weight is read once per step, far more than the 50 MB L2 holds."""
    from paddle_tpu_torch.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
    from paddle_tpu_torch.quantization import _quantize_weight
    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=DEVICE, dtype=torch.bfloat16)
    w, s = _quantize_weight(
        torch.randn(N, K, generator=g, device=DEVICE,
                    dtype=torch.bfloat16) * 0.02, 0)
    s = s.float()
    out = quant_matmul(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs().max().item()
    rel = diff / max(ref.float().abs().max().item(), 1e-6)
    ok = rel <= QMM_RTOL and bool(torch.isfinite(out.float()).all()) and \
        out.shape == (M, N)
    del out, ref
    ms = timer(lambda: quant_matmul(x, w, s), cold=True)
    plain_ms = timer(lambda: quant_matmul_plain(x, w, s), cold=True,
                     iters=10)
    wb = (w.float() * s[:, None]).to(torch.bfloat16)
    library_ms = timer(lambda: F.linear(x, wb), cold=True)
    graphs = {}
    if M > 8:  # the prefill kernel; decode's records stay as they were
        graphs = dict(
            graph_ms=timer.graph(lambda: quant_matmul(x, w, s), cold=True),
            library_graph_ms=timer.graph(lambda: F.linear(x, wb),
                                         cold=True))
    del wb
    nbytes = M * K * 2 + N * K + N * 4 + M * N * 2
    bms, by = bound(nbytes, 2 * M * N * K)
    rec = dict(M=M, N=N, K=K, max_abs_err=diff, rel_err=rel, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, **graphs,
               library="F.linear on a bf16 copy of w*s (2x the weight bytes)",
               bound_ms=bms, bound_by=by, ok=ok)
    shown = "".join(f" {k} {v:.4f}" for k, v in graphs.items())
    print(f"quant_matmul M={M} N={N} K={K}: err {diff:.3e} (rel "
          f"{rel:.3e}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"F.linear bf16 {library_ms:.4f} ms bound {bms:.4f} ms ({by})"
          f"{shown}", flush=True)
    if not ok:
        fail(f"quant_matmul disagrees with quant_matmul_plain at M={M} "
             f"N={N} K={K}: relative error {rel} (limit {QMM_RTOL})")
    return rec


def kernel_phases(torch):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_chunked, paged_decode_attention_kernel,
        pick_chunk_pages)
    timer = Timer(torch)
    gpt_shape = dict(B=GPT_B, hq=GPT_H, hk=GPT_H, dh=GPT_D)
    flash = [flash_phase(torch, timer, GPT_S, **gpt_shape)] + \
        [flash_phase(torch, timer, S) for S in (1024, 304, 300)]
    bwd = [flash_bwd_phase(torch, timer, GPT_B, GPT_S, GPT_H, GPT_H, GPT_D),
           flash_bwd_phase(torch, timer, 1, 2048, HQ, HK, D)]
    short = [0, 1, 16, 17, 100, 161, 239, 240]
    lens = np.linspace(1, 2048, 8).astype(np.int64)
    decode = {}
    for quantized, suffix in ((False, ""), (True, "_q")):
        decode["paged_decode" + suffix] = [decode_phase(
            torch, timer, "paged_decode" + suffix,
            paged_decode_attention_kernel, 8, 15, short, seed=1,
            quantized=quantized)]
        decode["paged_decode_split" + suffix] = [decode_phase(
            torch, timer, "paged_decode_split" + suffix,
            paged_decode_attention_chunked, 8, 128, lens, seed=2,
            quantized=quantized, drop_pages=pick_chunk_pages(
                128, 16, D, 1 if quantized else 2, quantized))]
    qmm = [qmm_phase(torch, timer, 8, n, k, seed=3000 + i)
           for i, ((n, k), _) in enumerate(QMM_DECODE)]
    step_ms = sum(r["ms"] * per for r, (_, per) in zip(qmm, QMM_DECODE))
    step_bound = sum(r["bound_ms"] * per
                     for r, (_, per) in zip(qmm, QMM_DECODE))
    step_lib = sum(r["library_ms"] * per
                   for r, (_, per) in zip(qmm, QMM_DECODE))
    print(f"quant_matmul per decode step (M 8, 225 launches): kernel "
          f"{step_ms:.4f} ms, weight-read bound {step_bound:.4f} ms, "
          f"F.linear on bf16 copies {step_lib:.4f} ms", flush=True)
    prefill = [qmm_phase(torch, timer, QMM_PREFILL_M, n, k, seed=3100 + i)
               for i, ((n, k), _) in enumerate(QMM_PREFILL)]
    sums = {key: sum(r[key] * per for r, (_, per) in zip(prefill,
                                                         QMM_PREFILL))
            for key in ("ms", "graph_ms", "bound_ms", "library_ms",
                        "library_graph_ms")}
    launches = sum(per for _, per in QMM_PREFILL)
    print(f"quant_matmul per {QMM_PREFILL_M}-token prefill (M "
          f"{QMM_PREFILL_M}, {launches} layer launches): kernel "
          f"{sums['ms']:.4f} ms (graph {sums['graph_ms']:.4f}), bound "
          f"{sums['bound_ms']:.4f} ms, F.linear on bf16 copies "
          f"{sums['library_ms']:.4f} ms (graph "
          f"{sums['library_graph_ms']:.4f})", flush=True)
    qmm += prefill
    qmm.append(qmm_phase(torch, timer, QMM_SHORT_M, *QMM_PREFILL[0][0],
                         seed=3200))
    del timer
    torch.cuda.empty_cache()
    return {"flash_fwd": flash,
            "flash_bwd_dq": [r["flash_bwd_dq"] for r in bwd],
            "flash_bwd_dkv": [r["flash_bwd_dkv"] for r in bwd],
            **decode, "quant_matmul": qmm,
            "quant_matmul_decode_step": dict(
                ms=step_ms, bound_ms=step_bound, library_ms=step_lib),
            "quant_matmul_prefill": dict(M=QMM_PREFILL_M, launches=launches,
                                         **sums)}


# ---------------------------------------------------------------------------
# slice phase: Llama-3-8B served by the continuous-batching engine
# ---------------------------------------------------------------------------

def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count), and
    the decode routing counters."""
    from paddle_tpu_torch.inference.paged import ROUTE_COUNTS
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda)
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_chunked, paged_decode_attention_kernel)
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
    return {"flash_fwd": (flash_fwd_cuda, "launches"),
            "flash_bwd_dq": (flash_bwd_dq_cuda, "launches"),
            "flash_bwd_dkv": (flash_bwd_dkv_cuda, "launches"),
            "paged_decode": (paged_decode_attention_kernel, "launches"),
            "paged_decode_split": (paged_decode_attention_chunked,
                                   "launches"),
            "paged_decode_q": (paged_decode_attention_kernel, "launches_q"),
            "paged_decode_split_q": (paged_decode_attention_chunked,
                                     "launches_q"),
            "quant_matmul": (quant_matmul, "launches")}, ROUTE_COUNTS


def zero_counts():
    fns, routes = _counters()
    for f, attr in fns.values():
        setattr(f, attr, 0)
    for r in routes:
        routes[r] = 0


def read_counts():
    fns, routes = _counters()
    return {n: getattr(f, attr) for n, (f, attr) in fns.items()}, \
        dict(routes)


class Instrumented:
    """Times the model's serving calls (host clock around work that ends in
    a synchronize) and counts prefills and decode steps."""

    def __init__(self, torch, model):
        self.torch = torch
        self.model = model
        self.orig = (model.paged_prefill, model.paged_decode_step)
        model.paged_prefill = self._wrap(self.orig[0], "prefill")
        model.paged_decode_step = self._wrap(self.orig[1], "decode")
        self.reset()

    def reset(self):
        self.calls = {"prefill": 0, "decode": 0}
        self.secs = {"prefill": 0.0, "decode": 0.0}

    def _wrap(self, fn, kind):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.secs[kind] += time.perf_counter() - t
            self.calls[kind] += 1
            return r
        return run

    def restore(self):
        del self.model.paged_prefill
        del self.model.paged_decode_step


def _first_token_done(engine, rid):
    for req in list(engine.running.values()) + list(engine.finished.values()):
        if req.rid == rid:
            return bool(req.generated)
    return False


def serve(torch, inst, engine, prompts, new_tokens, per_step=2):
    """Requests arrive ``per_step`` per engine step; returns the run's
    numbers. Counters are zeroed just before and read just after."""
    inst.reset()
    zero_counts()
    pending = list(prompts)
    t_add, t_first = {}, {}
    decoded = 0
    t0 = time.perf_counter()
    while pending or engine.has_work:
        for _ in range(per_step):
            if pending:
                rid = engine.add_request(pending.pop(0), new_tokens)
                t_add[rid] = time.perf_counter()
        decoded += len(engine.step())
        now = time.perf_counter()
        for rid in t_add:
            if rid not in t_first and _first_token_done(engine, rid):
                t_first[rid] = now - t_add[rid]
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    ttft = sorted(t_first.values())
    return dict(requests=len(prompts), wall_s=wall,
                prefills=inst.calls["prefill"],
                prefill_s=inst.secs["prefill"],
                decode_steps=inst.calls["decode"],
                decode_s=inst.secs["decode"], decode_tokens=decoded,
                decode_tok_per_s=decoded / max(inst.secs["decode"], 1e-9),
                ttft_median_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                preemptions=engine.preemptions, launches=launches,
                routes=routes)


def kv8_attention(n):
    """The model's attention as an int8-cache engine computes it, for a
    dense forward over prompt + generated (prompt length ``n``): query
    positions before ``n`` attend the exact KV (prefill); later ones attend
    every K/V row rounded through int8 (``quantize_rows``, dequantized to
    bf16), as the decode steps read the int8 pools. Causal masks are
    bottom-right aligned, so the later queries keep their own positions."""
    from paddle_tpu_torch.kernels.flash_attention import (
        scaled_dot_product_attention)
    from paddle_tpu_torch.quantization import dequantize_rows, quantize_rows

    def attn(q, k, v, is_causal=False, **kw):
        out = scaled_dot_product_attention(q, k, v, is_causal=is_causal, **kw)
        if q.shape[1] > n:
            kq = dequantize_rows(*quantize_rows(k), dtype=k.dtype)
            vq = dequantize_rows(*quantize_rows(v), dtype=v.dtype)
            out[:, n:] = scaled_dot_product_attention(
                q[:, n:], kq, vq, is_causal=is_causal, **kw)
        return out
    return attn


def _dense_logits(torch, model, ids, attention=None):
    """The model's dense forward; its int8 layers (if any) run B7's plain
    version, ``quant_matmul_plain``, so the engine's B7 launches are held
    against it."""
    import paddle_tpu_torch.models.llama as llama_mod
    from paddle_tpu_torch.quantization import ConvertedInt8Linear
    orig = llama_mod.scaled_dot_product_attention
    int8 = [(m, m.kernel_mode) for m in model.modules()
            if isinstance(m, ConvertedInt8Linear)]
    if attention is not None:
        llama_mod.scaled_dot_product_attention = attention
    for m, _ in int8:
        m.kernel_mode = "dense"
    try:
        logits = model(torch.as_tensor(ids[None], device=DEVICE))[0].float()
    finally:
        llama_mod.scaled_dot_product_attention = orig
        for m, mode in int8:
            m.kernel_mode = mode
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits in the teacher-forced forward")
    return logits


def teacher_forced(torch, model, engine, kv8=False):
    """Dense forward over prompt + generated for every finished request;
    where the top-2 gap exceeds GAP_TOL the argmax must be the engine's
    token. Holds the paged-decode kernels against the flash kernel, and
    B7 against its plain version. With ``kv8`` (an int8-cache engine) the
    forward attends as the engine does (``kv8_attention``)."""
    checked = total = 0
    min_gap_checked = float("inf")
    with torch.inference_mode():
        for req in engine.finished.values():
            ids = np.concatenate([req.prompt, np.asarray(req.generated)])
            n = len(req.prompt)
            gen = torch.as_tensor(req.generated)
            span = slice(n - 1, n - 1 + len(req.generated))
            logits = _dense_logits(torch, model, ids,
                                   kv8_attention(n) if kv8 else None)
            top = logits[span].topk(2, dim=-1)
            gap = (top.values[:, 0] - top.values[:, 1]).cpu()
            arg = top.indices[:, 0].cpu()
            sure = gap > GAP_TOL
            bad = sure & (arg != gen)
            if bool(bad.any()):
                i = int(bad.nonzero()[0, 0])
                fail(f"request {req.rid}: token {i} is {int(gen[i])}, the "
                     f"dense forward says {int(arg[i])} (gap "
                     f"{float(gap[i]):.3f} > {GAP_TOL})")
            checked += int(sure.sum())
            total += len(req.generated)
            if bool(sure.any()):
                min_gap_checked = min(min_gap_checked,
                                      float(gap[sure].min()))
    share = checked / max(total, 1)
    rec = dict(checked=checked, total=total, gap_tol=GAP_TOL,
               min_gap_checked=min_gap_checked,
               reference="int8-KV dense forward" if kv8 else "dense forward")
    print(f"teacher-forced: {checked}/{total} positions above gap "
          f"{GAP_TOL} agree (smallest checked gap {min_gap_checked:.3f}): "
          f"{json.dumps(rec)}", flush=True)
    if share < MIN_CHECKED_SHARE:
        fail(f"teacher-forced check covered only {checked}/{total} "
             f"positions")
    return rec


# cuBLAS kernel-name fragments
_MATMUL_GROUPS = tuple((key, "matmul") for key in
                       ("nvjet", "gemm", "gemv", "cutlass", "xmma"))
_KERNEL_GROUPS = (
    ("quant_matmul", "int8 weight matmul (port)"),
    ("qmm_", "int8 weight matmul (port)"),
    ("paged_decode", "decode attention (port)"),
    ("flash_fwd", "flash forward (port)"),
) + _MATMUL_GROUPS


def profile_decode(torch, model, prompts, new_tokens, steps=4, label="A",
                   **engine_kw):
    """torch.profiler over ``steps`` decode-only steps of engine A's
    configuration (``engine_kw``: A8's int8 cache) with every slot live:
    the device's busy share of the window, kernels per step, and device
    time per step by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=2048, temperature=0.0,
                                      **engine_kw)
    for p in prompts:
        engine.add_request(p, new_tokens)
    engine.step()  # admits (prefills) every request and decodes once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    busy_ms = sum(ms for _, ms, _ in rows)
    groups = {}
    for name, ms, _ in rows:
        g = next((lab for key, lab in _KERNEL_GROUPS if key in name),
                 "other (elementwise, norms, rope, copies)")
        groups[g] = groups.get(g, 0.0) + ms / steps
    top = sorted(rows, key=lambda r: -r[1])[:8]
    rec = dict(steps=steps, live_slots=len(prompts),
               step_ms=wall_ms / steps, device_busy_ms_per_step=busy_ms / steps,
               device_busy_share=busy_ms / wall_ms if wall_ms else None,
               kernels_per_step=sum(c for _, _, c in rows) / steps,
               by_group_ms_per_step=groups,
               top=[dict(name=n[:80], ms_per_step=ms / steps,
                         launches_per_step=c / steps) for n, ms, c in top])
    print(f"profile (engine {label}, {len(prompts)} live slots, {steps} "
          f"decode steps): {json.dumps(rec)}", flush=True)
    if busy_ms == 0.0:
        print("profile: the profiler saw no device time; busy share not "
              "measured", flush=True)
    del engine
    return rec


_PREFILL_GROUPS = (
    ("quant_matmul", "B7 int8 weight matmul (port)"),
    ("qmm_", "B7 int8 weight matmul (port)"),
    ("flash_fwd", "B1 flash forward (port)"),
) + tuple((key, "cuBLAS bf16 matmul") for key, _ in _MATMUL_GROUPS)
_CACHE_WRITE = "cache writes (paged_prefill_write[_q])"
_PREFILL_OTHER = "elementwise, norms, rope, embedding, copies"


def profile_prefill(torch, model, prompt, label, **engine_kw):
    """One prefill of ``prompt`` (padded to a block multiple) into a fresh
    engine's cache: its host-clock time (median of 3, synchronized), then
    torch.profiler over one more: device time by kernel group, the cache
    writes read from a ``record_function`` range around them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import paddle_tpu_torch.inference.paged as paged_mod
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=2048, temperature=0.0,
                                      **engine_kw)
    cache = engine.cache

    def prefill():
        slot = cache.alloc_slot(len(prompt))
        try:
            model.paged_prefill(cache, slot, prompt)
        finally:
            cache.free_slot(slot)

    secs = []
    for _ in range(4):  # the first warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    names = ("paged_prefill_write", "paged_prefill_write_q")
    orig = {n: getattr(paged_mod, n) for n in names}

    def traced(fn):
        def run(*a, **kw):
            with record_function("cache_write"):
                return fn(*a, **kw)
        return run

    for n, fn in orig.items():
        setattr(paged_mod, n, traced(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for n, fn in orig.items():
            setattr(paged_mod, n, fn)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    groups, busy_us, n_kernels = {}, 0.0, 0
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n_kernels += 1
        grp = next((lab for key, lab in _PREFILL_GROUPS if key in e.name),
                   _PREFILL_OTHER)
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
    write_ms = sum(getattr(e, "device_time_total", 0.0) for e in events
                   if e.device_type != cuda and e.name == "cache_write") / 1e3
    groups[_CACHE_WRITE] = write_ms
    groups[_PREFILL_OTHER] = groups.get(_PREFILL_OTHER, 0.0) - write_ms
    rec = dict(tokens=len(prompt), padded=-(-len(prompt) // 16) * 16,
               prefill_ms=float(np.median(secs[1:])) * 1e3,
               profiled_ms=wall_ms, device_busy_ms=busy_us / 1e3,
               kernels=n_kernels, by_group_ms=groups)
    print(f"prefill profile (engine {label}): {json.dumps(rec)}", flush=True)
    if busy_us == 0.0:
        print("profile: the profiler saw no device time; prefill breakdown "
              "not measured", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def run_engine(torch, inst, model, name, prompts, new_tokens, **kw):
    """Serve ``prompts`` on a fresh engine (counts zeroed just before,
    read just after), then the teacher-forced check."""
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      temperature=0.0, **kw)
    torch.cuda.reset_peak_memory_stats()
    r = serve(torch, inst, engine, prompts, new_tokens)
    r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["teacher_forced"] = teacher_forced(torch, model, engine,
                                         kv8=engine.cache.quantized)
    r["max_blocks_per_seq"] = engine.cache.max_blocks_per_seq
    r["num_blocks"] = engine.cache.num_blocks
    for req in engine.finished.values():
        if len(req.generated) != new_tokens:
            fail(f"engine {name}: request {req.rid} produced "
                 f"{len(req.generated)} tokens, wanted {new_tokens}")
    if len(engine.finished) != len(prompts):
        fail(f"engine {name}: {len(engine.finished)} of {len(prompts)} "
             f"requests finished")
    print(f"engine {name}: {json.dumps(r)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return r


def convert_int8(torch, model):
    """The port's QAT, in place: every projection and the LM head become
    ConvertedInt8Linear (int8 [out, in] + bf16 per-channel scales)."""
    from paddle_tpu_torch.quantization import (
        QAT, ConvertedInt8Linear, FakeQuanterWithAbsMaxObserver, QuantConfig)
    t = time.perf_counter()
    qat = QAT(QuantConfig(activation=None,
                          weight=FakeQuanterWithAbsMaxObserver))
    qat.convert(qat.quantize(model, inplace=True), inplace=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    conv = [m for m in model.modules() if isinstance(m, ConvertedInt8Linear)]
    want = 7 * model.config.num_layers + 1
    if len(conv) != want:
        fail(f"QAT.convert made {len(conv)} int8 layers, expected {want}")
    rec = dict(int8_layers=len(conv), secs=time.perf_counter() - t,
               int8_weight_bytes=sum(m.w_int8.numel() for m in conv),
               scale_bytes=sum(m.w_scales.numel() * m.w_scales.element_size()
                               + m.w_scales_f32.numel() * 4 for m in conv),
               bf16_param_bytes=sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
               allocated_gib=torch.cuda.memory_allocated() / 2**30)
    print(f"Llama-3-8B converted in place: {json.dumps(rec)}", flush=True)
    return rec


def slice_phase(torch):
    from paddle_tpu_torch import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    print(f"Llama-3-8B: {model.num_params() / 1e9:.3f}B params bf16, built "
          f"in {time.perf_counter() - t:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    rng = np.random.default_rng(0)

    def prompts(n, lo, hi):
        out = []
        while len(out) < n:
            s = int(rng.integers(lo, hi + 1))
            if s % 16:  # never a block multiple
                out.append(rng.integers(0, cfg.vocab_size, s).astype(
                    np.int64))
        return out

    # name, engine kwargs, requests, prompt lengths, new tokens; the int8
    # engines (A8, B8) take A's and B's prompts and token counts
    bf16_engines = (("A", dict(max_seq_len=2048), 8, 100, 1000, 32),
                    ("B", dict(max_seq_len=240), 4, 20, 180, 24))
    results, asked = {}, {}
    inst = Instrumented(torch, model)
    for name, kw, n, lo, hi, new in bf16_engines:
        asked[name] = (prompts(n, lo, hi), new)
        results[name] = run_engine(torch, inst, model, name, *asked[name],
                                   **kw)
    inst.restore()
    results["A"]["profile"] = profile_decode(torch, model, asked["A"][0], 8)
    long_prompt = prompts(1, PREFILL_PROFILE_LEN, PREFILL_PROFILE_LEN)[0]
    results["A"]["prefill_profile"] = profile_prefill(torch, model,
                                                      long_prompt, "A")

    results["int8_model"] = convert_int8(torch, model)
    inst = Instrumented(torch, model)
    for name, kw, *_ in bf16_engines:
        results[name + "8"] = run_engine(torch, inst, model, name + "8",
                                         *asked[name], kv_cache_dtype="int8",
                                         **kw)
    inst.restore()
    prof8 = profile_decode(torch, model, asked["A"][0], 8, label="A8",
                           kv_cache_dtype="int8")
    results["A8"]["profile"] = prof8
    results["A8"]["prefill_profile"] = profile_prefill(
        torch, model, long_prompt, "A8", kv_cache_dtype="int8")
    pa, p8 = results["A"]["prefill_profile"], results["A8"]["prefill_profile"]
    print(f"prefill of {pa['tokens']} tokens: A {pa['prefill_ms']:.2f} ms, "
          f"A8 {p8['prefill_ms']:.2f} ms (host clock); TTFT medians: A "
          f"{results['A']['ttft_median_s']:.4f} s, A8 "
          f"{results['A8']['ttft_median_s']:.4f} s, B "
          f"{results['B']['ttft_median_s']:.4f} s, B8 "
          f"{results['B8']['ttft_median_s']:.4f} s", flush=True)
    b7 = prof8["by_group_ms_per_step"].get("int8 weight matmul (port)")
    mm = results["A"]["profile"]["by_group_ms_per_step"].get("matmul")
    print(f"decode step device time, 8 live slots: B7 (engine A8) {b7} ms "
          f"vs bf16 cuBLAS matmuls (engine A) {mm} ms", flush=True)

    del inst, model
    gc.collect()
    torch.cuda.empty_cache()

    none = {k: 0 for k in ("flash_bwd_dq", "flash_bwd_dkv", "paged_decode",
                           "paged_decode_split", "paged_decode_q",
                           "paged_decode_split_q", "quant_matmul")}
    want = {}
    for name, route in (("A", "paged_decode_split"), ("B", "paged_decode"),
                        ("A8", "paged_decode_split_q"),
                        ("B8", "paged_decode_q")):
        r = results[name]
        want[name] = dict(none, flash_fwd=r["prefills"] * LAYERS,
                          **{route: r["decode_steps"] * LAYERS})
        if name.endswith("8"):
            want[name]["quant_matmul"] = \
                (r["prefills"] + r["decode_steps"]) * QMM_PER_FORWARD
    for name, exp in want.items():
        got = results[name]["launches"]
        for k, n in exp.items():
            if got[k] != n:
                fail(f"engine {name}: {k} launched {got[k]} times, "
                     f"expected {n}")
        if results[name]["decode_steps"] == 0:
            fail(f"engine {name} ran no decode step")
    return results


# ---------------------------------------------------------------------------
# training phase: GPT-2 medium trained by TrainStep
# ---------------------------------------------------------------------------

def route_gate(torch, model, ids):
    """One forward + backward on the kernel route and one on the plain
    route (FLAGS_flash_kernel=plain), from the same weights and batch."""
    from paddle_tpu_torch.core import set_flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    runs = {}
    for mode in ("auto", "plain"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            model.zero_grad(set_to_none=True)
            loss = model.loss(ids, ids)
            loss.backward()
            norm = ClipGradByGlobalNorm.global_norm(
                [p.grad for p in model.parameters()]).item()
            qkv = [blk.attn.qkv_proj.weight.grad.float().flatten()
                   for blk in model.h]
            runs[mode] = (loss.item(), norm, qkv)
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
            model.zero_grad(set_to_none=True)
    (lk, nk, gk), (lp, np_, gp) = runs["auto"], runs["plain"]
    cos = [torch.nn.functional.cosine_similarity(a, b, dim=0).item()
           for a, b in zip(gk, gp)]
    rec = dict(loss_kernel=lk, loss_plain=lp,
               loss_rel_diff=abs(lk - lp) / abs(lp), grad_norm_kernel=nk,
               grad_norm_plain=np_, grad_norm_rel_diff=abs(nk - np_) / np_,
               qkv_grad_min_cosine=min(cos),
               tolerances=dict(loss_rtol=GATE_LOSS_RTOL,
                               norm_rtol=GATE_NORM_RTOL,
                               min_cosine=GATE_MIN_COSINE))
    print(f"route gate (kernel vs plain, one fwd+bwd): {json.dumps(rec)}",
          flush=True)
    if not (math.isfinite(lk) and math.isfinite(nk)):
        fail("route gate: non-finite loss or grad norm on the kernel route")
    if rec["loss_rel_diff"] > GATE_LOSS_RTOL or \
            rec["grad_norm_rel_diff"] > GATE_NORM_RTOL or \
            rec["qkv_grad_min_cosine"] < GATE_MIN_COSINE:
        fail(f"route gate: the kernel route disagrees with the plain "
             f"route: {rec}")
    return rec


_TRAIN_GROUPS = (
    ("flash_fwd", "attention forward (port)"),
    ("flash_bwd", "attention backward (port)"),
) + _MATMUL_GROUPS
_OTHER = "elementwise, norms, reductions, copies (fwd/bwd)"


def profile_train(torch, step, opt, ids, steps=PROFILED_STEPS):
    """torch.profiler over ``steps`` train steps: device busy time per step
    by kernel group, the optimizer's share (kernels launched inside its
    ``record_function`` range: clip + update + write-back), kernel
    launches per step and the idle share of the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    update = opt._update_all

    def traced_update():
        with record_function("optimizer"):
            update()

    opt._update_all = traced_update
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                step(ids)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        del opt._update_all
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    busy_us, n_kernels, groups, by_name = 0.0, 0, {}, {}
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n_kernels += 1
        g = next((lab for key, lab in _TRAIN_GROUPS if key in e.name),
                 _OTHER)
        groups[g] = groups.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    opt_us = sum(getattr(e, "device_time_total", 0.0) for e in events
                 if e.device_type != cuda and e.name == "optimizer")
    per_step = {g: us / 1e3 / steps for g, us in groups.items()}
    if opt_us > 0:
        per_step["optimizer (clip + AdamW + write-back)"] = \
            opt_us / 1e3 / steps
        per_step[_OTHER] = per_step.get(_OTHER, 0.0) - opt_us / 1e3 / steps
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = dict(steps=steps, step_ms=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps,
               idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               kernels_per_step=n_kernels / steps,
               by_group_ms_per_step=per_step,
               optimizer_measured=opt_us > 0,
               top=[dict(name=n[:90], ms_per_step=us / 1e3 / steps)
                    for n, us in top])
    print(f"profile (GPT-2 medium, {steps} train steps): {json.dumps(rec)}",
          flush=True)
    if busy_ms == 0.0:
        print("profile: the profiler saw no device time; busy share not "
              "measured", flush=True)
    return rec


def train_phase(torch):
    from paddle_tpu_torch import AdamW, GPT, GPTConfig, TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2_medium()
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads) != \
            (GPT_LAYERS, GPT_H * GPT_D, GPT_H):
        fail(f"GPTConfig.gpt2_medium() is not the shape this script "
             f"times its kernels at: {cfg}")
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GPT(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (GPT_B, GPT_S), device=DEVICE,
                        generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GPT-2 medium: {n_params / 1e6:.1f}M params bf16, built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    gate = route_gate(torch, model, ids)

    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, opt, lambda m, x: m.loss(x, x))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step(ids) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(step(ids))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches, _ = read_counts()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    tok_s = GPT_B * GPT_S * TIMED_STEPS / secs
    flops_tok = model.flops_per_token(GPT_S)
    rec = dict(config="gpt2_medium", batch=GPT_B, seq=GPT_S, steps=steps,
               losses=losses, step_ms=secs / TIMED_STEPS * 1e3,
               tokens_per_s=tok_s, flops_per_token=flops_tok,
               mfu=flops_tok * tok_s / BF16_FLOPS_PER_S,
               peak_mem_gib=peak / 2**30, launches=launches, gate=gate)
    shown = {k: v for k, v in rec.items() if k != "gate"}
    print(f"train: {json.dumps(shown)}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall on a repeated batch: {losses}")
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=GPT_LAYERS * steps,
                flash_bwd_dq=GPT_LAYERS * steps,
                flash_bwd_dkv=GPT_LAYERS * steps)
    for k, n in want.items():
        if launches[k] != n:
            fail(f"train: {k} launched {launches[k]} times, expected {n}")
    rec["profile"] = profile_train(torch, step, opt, ids)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


KERNELS = (
    ("flash_fwd", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_bwd_dq", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("flash_bwd_dkv", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
    ("paged_decode", "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:133"),
    ("paged_decode_split",
     "paddle_tpu_torch/kernels/csrc/paged_decode_split.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:186"),
    ("paged_decode_q", "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:156"),
    ("paged_decode_split_q",
     "paddle_tpu_torch/kernels/csrc/paged_decode_split.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:186"),
    ("quant_matmul", "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false", code=2)
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not beside chip_smoke.py: {e}", code=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t
    print(f"built {len(_build.SOURCES)} kernels in {build_s:.1f} s",
          flush=True)
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    phases = kernel_phases(torch)
    served = slice_phase(torch)
    trained = train_phase(torch)

    records = []
    for name, source, replaces in KERNELS:
        # the first record of each kernel is at its main path's shape
        main_rec = phases[name][0]
        launches = sum(served[e]["launches"][name]
                       for e in ("A", "B", "A8", "B8")) \
            + trained["launches"][name]
        paths = {}
        if name == "quant_matmul":  # decode (above) and prefill
            pre = next(r for r in phases[name] if r["M"] > 8)
            paths["prefill"] = dict(
                {k: pre[k] for k in ("M", "N", "K", "ms", "graph_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_graph_ms")},
                per_prefill=phases["quant_matmul_prefill"])
        records.append(dict(**paths,
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in phases[name]),
            ms=main_rec["ms"], kernel_ms=main_rec["ms"],
            plain_ms=main_rec["plain_ms"], bound_ms=main_rec["bound_ms"],
            bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"]))
    print("record " + json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s,
        "phases": phases, "served": served, "trained": trained}),
        flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
