#!/usr/bin/env python3
"""Compare the int8 weight matmul (B7) of several checkouts of the PyTorch
port on one GPU, in one call.

    python3 tools/torch_qmm_ab.py DIR[@C] [DIR[@C] ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). Each
runs in a process of its own, in the order given: give the older version
first and last (old, new, new, old) so drift on the card shows. ``DIR@C``
forces the decode kernel's cluster size (its split of K) to C in place of
``decode_plan``'s choice, where the checkout has that plan. A run builds
that checkout's ``quant_matmul`` source and, through this repository's
``chip_smoke.py`` (only the package comes from DIR), for M 1, 4 and 8:

- each of Llama-3-8B's five decode shapes (``QMM_DECODE``), held against
  the plain version: CUDA events around the wrapper (``ms``), a CUDA-graph
  replay (``graph_ms``) and the wrapper's host time per call
  (``host_ms``), the L2 evicted before each launch; at M 8 also
  ``F.linear`` on a bf16 copy and ``torch._weight_int8pack_mm`` where this
  build has it for CUDA;
- one decode layer's seven launches as one graph (``layer``), and the
  step from it (32 layers and the LM head);
- the prefill kernel at the gate/up shape and M 300 (events, graph);
- where the checkout takes any K (``K_ALIGN``), the ragged loader at
  ``chip_smoke.py``'s ``unaligned_qmm_phase`` shape (N 14336, K 4100) for
  bf16, fp16 and float32 x at M 300 and 8 (events, graph, cold L2; the
  error against the plain version);
- SHA-256 digests of the outputs on fixed inputs (numpy, seeded):
  ``digests["decode"]`` at the five decode shapes and M 1, 4, 8,
  ``digests["prefill"]`` at the four layer shapes and M 112, 1008. The
  kernels use no atomics, so equal code gives equal bits; the GPU tests
  hold the prefill digests to the recorded ones.

Each run also times the floor under any one-kernel graph replay timed
this way (``floor_graph_ms``: a one-element add). Prints the card's name
and power limit, one ``run {...}`` JSON line per run and one
``summary {...}`` line.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MS = (1, 4, 8)
KEYS = ("ms", "graph_ms", "host_ms", "library_ms", "library_graph_ms",
        "int8pack_ms", "int8pack_graph_ms", "bound_ms", "rel_err")
# (N, K) of the decode shapes and of the prefill layer shapes, and the
# prefill lengths whose digests are held
DECODE_SHAPES = ((14336, 4096), (4096, 4096), (1024, 4096), (4096, 14336),
                 (128256, 4096))
PREFILL_SHAPES = DECODE_SHAPES[:4]
PREFILL_MS = (112, 1008)
# the prefill lengths timed at the gate/up shape (the float32 Llama's
# prompts: ``chip_smoke.py`` FAULT_PROMPTS)
PREFILL_TIMED = (300,)
# the ragged loader's shape (K % 16 != 0) and its M
RAGGED_NK = (14336, 4100)
RAGGED_MS = (300, 8)


def digests(qm, which=("decode", "prefill")):
    """Digests of ``qm.quant_matmul``'s outputs (``qm``: a checkout's
    ``paddle_tpu_torch.kernels.quant_matmul``) on fixed numpy inputs:
    weights uniform in -127..127, scales uniform in [1e-3, 2e-3) (rounded
    to bf16, passed as float32), x standard normal."""
    import numpy as np
    import torch

    def sha(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()

    out = {}
    for kind, shapes, ms in (("decode", DECODE_SHAPES, MS),
                             ("prefill", PREFILL_SHAPES, PREFILL_MS)):
        if kind not in which:
            continue
        out[kind] = {}
        for n, k in shapes:
            rng = np.random.default_rng(n + k)
            w = torch.from_numpy(rng.integers(-127, 128, (n, k),
                                              dtype=np.int8)).cuda()
            s = torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(
                np.float32)).cuda().bfloat16().float()
            for m in ms:
                x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                    np.float32)).cuda().bfloat16()
                out[kind][f"M{m}_N{n}_K{k}"] = sha(qm.quant_matmul(x, w, s))
            del w
    return out


def ragged(torch, cs, qm, timer):
    """Records of the ragged loader at RAGGED_NK for each x dtype and M."""
    n, k = RAGGED_NK
    _, w, s = cs.qmm_inputs(torch, RAGGED_MS[0], n, k, 4990)
    x = torch.randn(RAGGED_MS[0], k, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(4990))
    out = {}
    for dtype, fn in ((torch.bfloat16, qm.quant_matmul),
                      (torch.float16, qm.quant_matmul_f16),
                      (torch.float32, qm.quant_matmul_x3)):
        for m in RAGGED_MS:
            xm = x[:m].to(dtype)
            run = lambda: fn(xm, w, s)
            rel, _ = cs.rel_err(run(), qm.quant_matmul_plain(xm, w, s))
            out[f"M{m}_N{n}_K{k}_{cs._dt(dtype)}"] = dict(
                ms=timer(run, cold=True), graph_ms=timer.graph(run, cold=True),
                rel_err=rel)
    return out


def one(spec):
    """Time ``spec``'s (DIR or DIR@C) B7; one JSON dict."""
    root, _, cluster = spec.partition("@")
    sys.path.insert(0, os.path.abspath(root))
    import torch
    mod = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    if cluster:
        if not hasattr(qm, "decode_plan"):
            raise RuntimeError(f"{root} has no decode cluster to force")
        qm.decode_plan = functools.partial(qm.decode_plan,
                                           cluster=int(cluster))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["quant_matmul"])
    timer = cs.Timer(torch)
    out = {"root": spec}
    for m in MS:
        recs = [cs.qmm_phase(torch, timer, m, n, k, seed=3000 + i,
                             plain=False, library=m == 8)
                for i, ((n, k), _) in enumerate(cs.QMM_DECODE)]
        for ((n, k), _), rec in zip(cs.QMM_DECODE, recs):
            out[f"M{m}_N{n}_K{k}"] = {key: rec[key] for key in KEYS
                                      if key in rec}
        layer = cs.qmm_layer_phase(torch, timer, M=m, library=m == 8)
        out[f"M{m}_layer"] = layer
        out[f"M{m}_step"] = cs.qmm_decode_step(recs, layer)
    (n, k), _ = cs.QMM_DECODE[0]
    for m in PREFILL_TIMED:
        rec = cs.qmm_phase(torch, timer, m, n, k, seed=3100, plain=False,
                           library=False)
        out[f"M{m}_N{n}_K{k}"] = {key: rec[key] for key in KEYS
                                  if key in rec}
    if hasattr(qm, "K_ALIGN"):
        out.update(ragged(torch, cs, qm, timer))
    out["digests"] = digests(qm)
    tiny = torch.zeros(1, device="cuda")
    out["floor_graph_ms"] = timer.graph(lambda: tiny.add_(1), cold=True)
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
            sys.exit(f"torch_qmm_ab: the run of {root} failed "
                     f"(exit {r.returncode})")
        print(line, flush=True)
        runs.append(json.loads(line[4:]))
    summary = {}
    for run in runs:
        for name, rec in run.items():
            if not isinstance(rec, dict) or name == "digests":
                continue
            for key, val in rec.items():
                if isinstance(val, (int, float)):
                    summary.setdefault(f"{run['root']} {name} {key}",
                                       []).append(val)
        summary.setdefault(f"{run['root']} floor_graph_ms", []).append(
            run["floor_graph_ms"])
        for kind, digs in run["digests"].items():
            for name, dig in digs.items():
                summary.setdefault(f"{run['root']} {kind} {name} digest",
                                   []).append(dig)
    print("summary " + json.dumps({"card": card, "runs": summary}),
          flush=True)


if __name__ == "__main__":
    main()
