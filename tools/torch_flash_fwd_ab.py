#!/usr/bin/env python3
"""Compare the flash-attention forward (B1: dense branch, B1-seg: segment
branch) of several checkouts of the PyTorch port on one GPU, in one call.

    python3 tools/torch_flash_fwd_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). Each
runs in a process of its own, in the order given: give the older version
first and last (old, new, new, old) so drift on the card shows. A run
builds that checkout's ``flash_fwd`` source and, at five shapes, times
``flash_fwd_cuda`` as CUDA events around the wrapper (``ms``: where the
wrapper's host work outlasts the kernel, the host), as CUDA-graph replays
(``graph_ms``: the device alone) and as the wrapper's host time per call,
back to back (``host_ms``):

- GPT: GPT-2 medium, B 8, S 1024, H 16, D 64, causal (dense, control);
- Llama: Llama-3-8B's prefill, B 1, S 1024, Hq 32, Hk 8, D 128, causal
  (dense, control);
- D256, D256-S197: ``chip_smoke.py``'s head-dim-256 cases, B 1, Hq 16,
  Hk 4, D 256, S 2048 causal and S 197 non-causal (Gemma's head width);
- V1, V2, V3, V4: ``chip_smoke.py``'s packed varlen cases (segment
  branch; V4 at Gemma-2 9B's Hq 16, Hk 8, D 256);
- F32-D160, F32-D256: float32 B1 on three bf16 pieces
  (``flash_fwd_x3_cuda`` on ``split_bf16x3_cuda``'s pieces, the head dim
  padded to 256) at ``chip_smoke.py``'s ``WIDE_FWD_CASES`` D 160 (B 1,
  S 1024, Hq 16, Hk 4) and D 256 (Gemma-2 9B's Hq 16, Hk 8, S 2048),
  causal; skipped by a checkout whose B1 takes no float32 pieces there.

Each shape also gets the forward's error against
``flash_attention_plain`` (per query row: max |kernel - plain| / max
|plain|; LSE absolute), its bound (``chip_smoke.bound`` over the visible
pairs), one PyTorch call's time as the yardstick (SDPA, or ``varlen_attn``
/ masked SDPA as ``chip_smoke.varlen_library`` picks) and, on the segment
cases, how the forward's (query block, key tile) pairs classify
(``chip_smoke.tile_pair_counts``, blocks of 64 / G positions). The
measuring code is this repository's ``chip_smoke.py`` for every DIR;
only the package comes from DIR. Prints the card's name and power limit,
one ``run {...}`` JSON line per run, and one ``summary {...}`` line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(torch, cs):
    """(name, causal, q, k, v, segment kwargs, visible pairs, id bytes,
    library forward, segment ids or None) of each shape."""
    for name, B, S, hq, hk, dh, causal in (
            ("GPT", cs.GPT_B, cs.GPT_S, cs.GPT_H, cs.GPT_H, cs.GPT_D, True),
            ("Llama", 1, 1024, cs.HQ, cs.HK, cs.D, True),
            ("D256", cs.WIDE_B, 2048, cs.WIDE_HQ, cs.WIDE_HK, 256, True),
            ("D256-S197", cs.WIDE_B, 197, cs.WIDE_HQ, cs.WIDE_HK, 256,
             False)):
        g = torch.Generator(device=cs.DEVICE).manual_seed(1000 + S + dh)
        mk = lambda h: torch.randn(B, S, h, dh, generator=g,
                                   device=cs.DEVICE, dtype=torch.bfloat16)
        q, k, v = mk(hq), mk(hk), mk(hk)
        lib = cs.sdpa_library(torch, *(t.transpose(1, 2) for t in (q, k, v)),
                              is_causal=causal)
        pairs = B * (S * (S + 1) // 2 if causal else S * S)
        yield name, causal, q, k, v, {}, pairs, 0, lib, None, None
    for dh, B, S, hq, hk in cs.WIDE_FWD_CASES:
        if dh > 256:
            continue
        g = torch.Generator(device=cs.DEVICE).manual_seed(5000 + dh)
        q, k, v = (torch.randn(B, S, h, dh, generator=g, device=cs.DEVICE)
                   for h in (hq, hk, hk))
        lib = cs.sdpa_library(torch, *(t.transpose(1, 2) for t in (q, k, v)),
                              is_causal=True)
        yield (f"F32-D{dh}", True, q, k, v, {"scale": dh ** -0.5},
               B * S * (S + 1) // 2, 0, lib, None, 256)
    for name, case in cs.varlen_cases(torch):
        seg = case["seg"]
        kw = dict(zip(("q_segment_ids", "kv_segment_ids", "q_positions",
                       "kv_positions"), seg), scale=case["scale"])
        _, lib, _ = cs.varlen_library(torch, case, case["q"], case["k"],
                                      case["v"], case["do"])
        yield (name, True, case["q"], case["k"], case["v"], kw,
               cs.visible_pairs(torch, seg, True),
               sum(x.numel() for x in seg) * 4, lib, seg, None)


def one(root):
    """Time the B1 of ``root`` at every shape; one JSON dict."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["flash_fwd", "flash_bwd"])
    timer = cs.Timer(torch)
    out = {"root": root}
    for name, causal, q, k, v, kw, pairs, idb, lib, seg, dp in cases(
            torch, cs):
        fwd = lambda: fa.flash_fwd_cuda(q, k, v, causal, **kw)
        if dp is not None:  # float32 as three pieces at head dim dp
            pieces = [fa.split_bf16x3_cuda(t, dp) for t in (q, k, v)]
            fwd = lambda: fa.flash_fwd_x3_cuda(*pieces, causal, **kw)
            try:
                fwd()
            except ValueError:
                continue
        o, lse = fwd()
        o = o[..., :q.shape[-1]]
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal,
                                                  return_lse=True, **kw)
        torch.cuda.synchronize()
        B, Sq, Hq, dh = q.shape
        es = q.element_size()
        qb, kvb = q.numel() * es, k.numel() * es
        bms, by = cs.bound(2 * qb + 2 * kvb + idb, 4 * dh * Hq * pairs,
                           cs.F32_SPLIT_FLOPS_PER_S if dp else
                           cs.BF16_FLOPS_PER_S)
        rec = dict(row_rel_err=cs.row_rel_err(o, o_ref),
                   lse_err=(lse - lse_ref).abs().max().item(),
                   finite=bool(torch.isfinite(o.float()).all()),
                   ms=timer(fwd), graph_ms=timer.graph(fwd),
                   host_ms=timer.host(fwd), bound_ms=bms, bound_by=by,
                   library_ms=timer(lib, iters=10),
                   library_graph_ms=timer.graph(lib, iters=10))
        if seg is not None:  # B1's blocks are B2's (``dq``)
            rec["tile_pairs"] = cs.tile_pair_counts(torch, seg, True, Hq,
                                                    k.shape[2])["dq"]
        del o, lse, o_ref, lse_ref
        out[name] = rec
        print(f"{root} {name}: {json.dumps(rec)}", file=sys.stderr,
              flush=True)
    return out


def main():
    if sys.argv[1:2] == ["--one"]:
        print("run " + json.dumps(one(sys.argv[2])), flush=True)
        return
    roots = sys.argv[1:]
    if not roots:
        sys.exit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True)
        sys.stderr.write(r.stderr[-4000:])
        line = next((x for x in r.stdout.splitlines()
                     if x.startswith("run ")), None)
        if r.returncode != 0 or line is None:
            sys.exit(f"torch_flash_fwd_ab: the run of {root} failed "
                     f"(exit {r.returncode})")
        print(line, flush=True)
        runs.append(json.loads(line[4:]))
    summary = {}
    for run in runs:
        for shape, rec in run.items():
            if shape == "root":
                continue
            for key in ("ms", "graph_ms", "host_ms", "library_ms",
                        "library_graph_ms", "row_rel_err"):
                summary.setdefault(f"{run['root']} {shape} {key}",
                                   []).append(rec[key])
    print("summary " + json.dumps({"card": card, "runs": summary}),
          flush=True)


if __name__ == "__main__":
    main()
