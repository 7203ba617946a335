#!/usr/bin/env python3
"""Compare the flash-attention backward kernels (B2: dQ, B3: dK/dV), dense
and segment branches, of several checkouts of the PyTorch port on one GPU,
in one call.

    python3 tools/torch_flash_bwd_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). Each
runs in a process of its own, in the order given: give the older version
first and last (old, new, new, old) so drift on the card shows. ``DIR@C``
runs DIR with B3's cluster size forced to C (capped by the GQA group) in
place of ``dkv_cluster``'s choice, where the checkout has one. A run
builds that checkout's ``flash_fwd`` and ``flash_bwd`` sources and, at
nine shapes, times ``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` as
CUDA events around the wrapper (``ms``: where the wrapper's host work
outlasts the kernel, the host), as CUDA-graph replays (``graph_ms``: the
device alone) and as the wrapper's host time per call, back to back
(``host_ms``), with O and LSE from that checkout's forward:

- GPT: GPT-2 medium, B 8, S 1024, H 16, D 64, causal (the training main
  path);
- Llama: Llama-3-8B, B 1, S 2048, Hq 32, Hk 8, D 128, causal;
- D256: ``chip_smoke.py``'s head-dim-256 case, B 1, S 2048, Hq 16, Hk 4,
  D 256, causal (Gemma's head width); D384 and D512 the same above 256
  (the streamed kernels);
- V1, V2, V3, V4: ``chip_smoke.py``'s packed varlen cases (segment
  branch; V4 at Gemma-2 9B's Hq 16, Hk 8, D 256).

Each shape also gets the relative error of dQ, dK, dV against
``flash_attention_bwd_plain`` (max |kernel - plain| / max |plain|), the
bound of each kernel (``chip_smoke.bwd_bounds`` over the visible pairs)
and one PyTorch call's backward as the yardstick (SDPA, or ``varlen_attn``
/ masked SDPA as ``chip_smoke.varlen_library`` picks). The measuring code
is this repository's ``chip_smoke.py`` for every DIR; only the package
comes from DIR. Prints the card's name and power limit, one ``run {...}``
JSON line per run, and one ``summary {...}`` line.
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
    """(name, q, k, v, do, segment kwargs, library call) of each shape."""
    for name, B, S, hq, hk, dh in (("GPT", cs.GPT_B, cs.GPT_S, cs.GPT_H,
                                    cs.GPT_H, cs.GPT_D),
                                   ("Llama", 1, 2048, cs.HQ, cs.HK, cs.D),
                                   ("D256", cs.WIDE_B, 2048, cs.WIDE_HQ,
                                    cs.WIDE_HK, 256),
                                   ("D384", cs.WIDE_B, 2048, cs.WIDE_HQ,
                                    cs.WIDE_HK, 384),
                                   ("D512", cs.WIDE_B, 2048, cs.WIDE_HQ,
                                    cs.WIDE_HK, 512)):
        g = torch.Generator(device=cs.DEVICE).manual_seed(2000 + S + dh)
        mk = lambda h: torch.randn(B, S, h, dh, generator=g,
                                   device=cs.DEVICE, dtype=torch.bfloat16)
        q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
        lib = cs.sdpa_backward_library(torch, *(t.transpose(1, 2) for t in
                                                (q, k, v, do)))
        yield name, q, k, v, do, {}, B * S * (S + 1) // 2, 0, lib
    for name, case in cs.varlen_cases(torch):
        seg = case["seg"]
        kw = dict(zip(("q_segment_ids", "kv_segment_ids", "q_positions",
                       "kv_positions"), seg), scale=case["scale"])
        _, _, lib = cs.varlen_library(torch, case, case["q"], case["k"],
                                      case["v"], case["do"])
        yield (name, case["q"], case["k"], case["v"], case["do"], kw,
               cs.visible_pairs(torch, seg, True),
               sum(x.numel() for x in seg) * 4, lib)


def one(spec):
    """Time the B2 and B3 of ``spec`` (DIR or DIR@C) at every shape; one
    JSON dict."""
    root, _, cluster = spec.partition("@")
    sys.path.insert(0, os.path.abspath(root))
    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    if cluster:
        if not hasattr(fa, "dkv_cluster"):
            raise RuntimeError(f"{root} has no B3 cluster to force")
        fa.dkv_cluster = lambda B, Hk, G, Sk, D=128: min(int(cluster), G)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["flash_fwd", "flash_bwd"])
    timer = cs.Timer(torch)
    out = {"root": spec}
    for name, q, k, v, do, kw, pairs, idb, lib in cases(torch, cs):
        o, lse = fa.flash_fwd_cuda(q, k, v, True, **kw)
        delta = fa.flash_delta(o, do)
        dq_call = lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True,
                                               **kw)
        dkv_call = lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 True, **kw)
        outs = (dq_call(),) + dkv_call()
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True, **kw)
        torch.cuda.synchronize()
        rec = {"rel_err": {
            n: ((a.float() - r.float()).abs().max() /
                r.float().abs().max().clamp_min(1e-6)).item()
            for n, a, r in zip(("dq", "dk", "dv"), outs, refs)}}
        del outs, refs
        bounds = cs.bwd_bounds(q, k, lse, pairs, idb)
        for kname, fn in (("flash_bwd_dq", dq_call),
                          ("flash_bwd_dkv", dkv_call)):
            rec[kname] = dict(ms=timer(fn), graph_ms=timer.graph(fn),
                              host_ms=timer.host(fn),
                              bound_ms=bounds[kname][0],
                              bound_by=bounds[kname][1])
        rec["library_bwd_ms"] = timer(lib, iters=10)
        out[name] = rec
        print(f"{spec} {name}: {json.dumps(rec)}", file=sys.stderr,
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
            sys.exit(f"torch_flash_bwd_ab: the run of {root} failed "
                     f"(exit {r.returncode})")
        print(line, flush=True)
        runs.append(json.loads(line[4:]))
    summary = {}
    for run in runs:
        for shape, rec in run.items():
            if shape == "root":
                continue
            for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
                for key in ("ms", "graph_ms", "host_ms"):
                    summary.setdefault(f"{run['root']} {shape} {kname} {key}",
                                       []).append(rec[kname][key])
            summary.setdefault(f"{run['root']} {shape} library_bwd_ms",
                               []).append(rec["library_bwd_ms"])
    print("summary " + json.dumps({"card": card, "runs": summary}),
          flush=True)


if __name__ == "__main__":
    main()
