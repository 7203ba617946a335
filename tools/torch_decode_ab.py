#!/usr/bin/env python3
"""Compare the paged-decode kernels of several checkouts of the PyTorch
port on one GPU, in one call: the per-page kernel (B4: bf16 pools, B5:
int8 pools), the split route for long tables (B6: bf16 pools, B6q:
int8 pools) and, where a checkout has it, the CUDA cores' kernel for the
dtypes and shapes those refuse (``paged_decode_attention_simt``).

    python3 tools/torch_decode_ab.py DIR[@C] [DIR[@C] ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). Each
runs in a process of its own, in the order given: give the older version
first and last (old, new, new, old) so drift on the card shows. ``DIR@C``
forces the split route's cluster size to C in place of
``split_cluster_plan``'s choice, where the checkout has that plan. A run
builds that checkout's paged-decode sources and times, through
``chip_smoke.decode_phase`` (the L2 evicted before each launch), CUDA
events around the wrapper (``ms``), CUDA-graph
replays (``graph_ms``), the wrapper's host time per call (``host_ms``)
and SDPA over the pre-gathered KV as the yardstick (``library_ms``,
``library_graph_ms``), each kernel held per slot against the plain
version, at two shapes (Hq 32, Hk 8, D 128, 16-token pages, B 8):

- ``paged_decode``, ``paged_decode_q``: the per-page kernel at the
  per-page route's shape (15-page tables, lens 0-240, engine B's);
- ``paged_decode_split``, ``paged_decode_split_q``: the split route's
  wrapper ``paged_decode_attention_chunked`` at its shape (128-page
  tables, lens ``linspace(1, 2048, 8)``, engine A's);
- ``per_page_at_split``, ``per_page_at_split_q``: the per-page kernel's
  wrapper at the split route's shape, the yardstick of the split route;
- ``simt_<dtype>_<shape>``: ``paged_decode_attention_simt`` (through
  ``chip_smoke.simt_decode_case``: events, graph replays, SDPA over the
  gathered rows, the bound) with float32 and fp16 queries over pools of
  their dtype and float32 queries over int8 pools (``f32q``), at both
  shapes (``short``: 16-page tables, lens 1-256, chip_smoke's; ``long``:
  engine A's), held per slot to SIMT_RTOL.

Each run also prints SHA-256 digests of the bf16 kernels' outputs (the
per-page kernel at both shapes, the split route at its own;
``digests``: equal code gives equal bits, the kernels have no atomics)
and times the floor under any one-kernel call timed this way
(``floor_graph_ms``: a graph replay of a one-element add). The measuring
code is this repository's ``chip_smoke.py`` for every DIR; only the
package comes from DIR. Prints the card's name and power limit, one
``run {...}`` JSON line per run, and one ``summary {...}`` line.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHORT = [0, 1, 16, 17, 100, 161, 239, 240]   # chip_smoke.py's B4/B5 lens
LONG = np.linspace(1, 2048, 8).astype(np.int64)  # its B6/B6q lens
KEYS = ("ms", "graph_ms", "host_ms", "library_ms", "library_graph_ms",
        "bound_ms", "slot_rel_err", "rel_err", "max_abs_err")


def _digest(torch, cs, wrapper, B, mbps, lens, seed, quantized):
    """SHA-256 of ``wrapper``'s output on ``chip_smoke.decode_inputs``."""
    from paddle_tpu_torch.quantization import quantize_rows
    q, kp, vp, tbl, sl = cs.decode_inputs(torch, B, mbps, lens, seed)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    out = wrapper(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    return hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def one(spec):
    """Time ``spec``'s (DIR or DIR@C) decode kernels; one JSON dict."""
    root, _, cluster = spec.partition("@")
    sys.path.insert(0, os.path.abspath(root))
    import torch
    mod = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(cs)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    if cluster:
        if not hasattr(pa, "split_cluster_plan"):
            raise RuntimeError(f"{root} has no split cluster to force")
        pa.split_cluster_plan = functools.partial(pa.split_cluster_plan,
                                                  cluster=int(cluster))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all([n for n in _build.SOURCES
                      if n.startswith("paged_decode")])
    timer = cs.Timer(torch)
    out = {"root": spec, "digests": {}}
    for suffix, quantized in (("", False), ("_q", True)):
        for name, wrapper, mbps, lens, seed in (
                ("paged_decode", pa.paged_decode_attention_kernel, 15,
                 SHORT, 1),
                ("paged_decode_split", pa.paged_decode_attention_chunked,
                 128, LONG, 2),
                ("per_page_at_split", pa.paged_decode_attention_kernel, 128,
                 LONG, 2)):
            rec = cs.decode_phase(torch, timer, name + suffix, wrapper, 8,
                                  mbps, lens, seed=seed, quantized=quantized)
            out[name + suffix] = {k: rec[k] for k in KEYS if k in rec}
            if name != "per_page_at_split":
                out["digests"][name + suffix] = _digest(
                    torch, cs, wrapper, 8, mbps, lens, seed, quantized)
    if hasattr(pa, "paged_decode_attention_simt"):
        short = np.linspace(1, 256, 8).astype(np.int64)
        for tag, dtype, quantized in (("f32", torch.float32, False),
                                      ("f16", torch.float16, False),
                                      ("f32q", torch.float32, True)):
            for shape, mbps, lens, seed in (("short", 16, short, 4950),
                                            ("long", 128, LONG, 4951)):
                rec = cs.simt_decode_case(torch, timer, f"simt_{tag}",
                                          dtype, quantized, mbps, lens,
                                          seed)
                out[f"simt_{tag}_{shape}"] = {k: rec[k] for k in KEYS
                                              if k in rec}
    # the floor under any one-kernel call timed this way: a graph replay
    # of one trivial kernel (a one-element add), L2 evicted before it
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
            sys.exit(f"torch_decode_ab: the run of {root} failed "
                     f"(exit {r.returncode})")
        print(line, flush=True)
        runs.append(json.loads(line[4:]))
    summary = {}
    for run in runs:
        for name, rec in run.items():
            if not isinstance(rec, dict) or name == "digests":
                continue
            for key, val in rec.items():
                summary.setdefault(f"{run['root']} {name} {key}",
                                   []).append(val)
        summary.setdefault(f"{run['root']} floor_graph_ms", []).append(
            run["floor_graph_ms"])
        for name, dig in run["digests"].items():
            summary.setdefault(f"{run['root']} {name} digest",
                               []).append(dig)
    print("summary " + json.dumps({"card": card, "runs": summary}),
          flush=True)


if __name__ == "__main__":
    main()
