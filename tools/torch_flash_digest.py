#!/usr/bin/env python3
"""SHA-256 digests of the dense flash kernels' outputs (B1, B2, B3) on fixed
inputs, to show that a checkout's dense branch gives bit for bit what
another's gave.

    python3 tools/torch_flash_digest.py [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``; the
default is this repository) and runs in a process of its own: it builds
that checkout's ``flash_fwd`` and ``flash_bwd`` sources and prints one
``digest {...}`` JSON line with the card's name, the DIR and, for two
shapes (GPT-2 medium's heads at S 300 and Llama-3-8B's GQA at S 200,
causal), the digests of O and LSE (``flash_fwd_cuda``), dQ
(``flash_bwd_dq_cuda``) and dK, dV (``flash_bwd_dkv_cuda``). The inputs
come from numpy with a fixed seed, cast to bf16 on the card; the kernels
use no atomics, so equal code gives equal bits. The GPU tests hold the
current tree to digests recorded from an earlier one with this script.

The line also carries ``seg_digests``: the segment branch's outputs at
B 2, S 300, Hq 16, Hk 4, D 64, causal, ids (pos // 40) % 3 with 20 orphan
queries: O and LSE of B1-seg, and dQ of B2-seg and dK, dV of B3-seg on O
and LSE from ``flash_attention_plain`` (the same inputs for every
checkout, whatever its forward gives).

And ``wide_digests``: O and LSE of bf16 B1 at head dims 256
(``flash_fwd_256_kernel``) and 384 (``flash_fwd_xl_kernel``), B 1, S 300,
Hq 16, Hk 4, causal, dense and with the segment ids above.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# (B, S, Hq, Hk, D), all causal
SHAPES = ((2, 300, 16, 16, 64), (1, 200, 32, 8, 128))


def digests(fa):
    """Digests of the dense kernels of ``fa`` (a checkout's
    ``paddle_tpu_torch.kernels.flash_attention``) on the fixed inputs."""
    import numpy as np
    import torch

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    out = {}
    for B, S, hq, hk, dh in SHAPES:
        rng = np.random.default_rng(B * S + dh)
        mk = lambda h: torch.from_numpy(rng.standard_normal(
            (B, S, h, dh)).astype(np.float32)).to("cuda", torch.bfloat16)
        q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
        o, lse = fa.flash_fwd_cuda(q, k, v, True)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
        torch.cuda.synchronize()
        out[f"B{B}_S{S}_Hq{hq}_Hk{hk}_D{dh}"] = dict(
            flash_fwd=sha(o, lse), flash_bwd_dq=sha(dq),
            flash_bwd_dkv=sha(dk, dv))
    return out


def seg_digests(fa):
    """Digests of the segment kernels of ``fa`` on fixed inputs; B2-seg
    and B3-seg take O and LSE from the plain forward."""
    import numpy as np
    import torch

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    B, S, hq, hk, dh = 2, 300, 16, 4, 64
    rng = np.random.default_rng(7)
    mk = lambda h: torch.from_numpy(rng.standard_normal(
        (B, S, h, dh)).astype(np.float32)).to("cuda", torch.bfloat16)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    kseg = ((pos // 40) % 3).expand(B, S).contiguous()
    qseg = kseg.clone()
    qseg[:, 150:170] = 5
    p = pos.expand(B, S).contiguous()
    kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg, q_positions=p,
              kv_positions=p.clone())
    o, lse = fa.flash_fwd_cuda(q, k, v, True, **kw)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, True, return_lse=True,
                                          **kw)
    delta = fa.flash_delta(o_p, do)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, True, **kw)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, True, **kw)
    torch.cuda.synchronize()
    return dict(flash_fwd=sha(o, lse), flash_bwd_dq=sha(dq),
                flash_bwd_dkv=sha(dk, dv))


def wide_digests(fa):
    """Digests of bf16 B1's outputs at D 256 and 384, dense and segment
    branch, on fixed inputs."""
    import numpy as np
    import torch

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    out = {}
    B, S, hq, hk = 1, 300, 16, 4
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    ids = ((pos // 40) % 3).expand(B, S).contiguous()
    p = pos.expand(B, S).contiguous()
    seg = dict(q_segment_ids=ids, kv_segment_ids=ids.clone(), q_positions=p,
               kv_positions=p.clone())
    for dh in (256, 384):
        rng = np.random.default_rng(dh)
        mk = lambda h: torch.from_numpy(rng.standard_normal(
            (B, S, h, dh)).astype(np.float32)).to("cuda", torch.bfloat16)
        q, k, v = mk(hq), mk(hk), mk(hk)
        for name, kw in (("dense", {}), ("seg", seg)):
            o, lse = fa.flash_fwd_cuda(q, k, v, True, **kw)
            torch.cuda.synchronize()
            out[f"D{dh}_{name}"] = sha(o, lse)
    return out


def one(root):
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    _build.build_all(["flash_fwd", "flash_bwd"])
    print("digest " + json.dumps(dict(
        card=torch.cuda.get_device_name(0), root=root,
        digests=digests(fa), seg_digests=seg_digests(fa),
        wide_digests=wide_digests(fa))), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    rc = 0
    for root in argv or [REPO]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
