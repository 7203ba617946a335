#!/usr/bin/env python3
"""Compare the per-page paged-decode kernels (B4: bf16 pools, B5: int8
pools) of several checkouts of the PyTorch port on one GPU, in one call.

    python3 tools/torch_decode_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (it holds ``paddle_tpu_torch/``). Each
runs in a process of its own, in the order given: give the older version
first and last (old, new, new, old) so drift on the card shows. A run
builds that checkout's ``paged_decode`` source, then times
``paged_decode_attention_kernel`` through ``chip_smoke.decode_phase`` at
the serving path's shape (B 8, Hq 32, Hk 8, D 128, 16-token pages,
15-page tables, lens 0-240, the L2 evicted before each launch): CUDA
events around the wrapper (``ms``), CUDA-graph replays (``graph_ms``),
the wrapper's host time per call (``host_ms``) and SDPA over the
pre-gathered KV as the yardstick (``library_ms``, ``library_graph_ms``);
the kernel is held per slot against the plain version. The measuring code
is this repository's ``chip_smoke.py`` for every DIR; only the package
comes from DIR. Each run also times the floor under any one-kernel call
timed this way (``floor_graph_ms``: a graph replay of a one-element add).
Prints the card's name and power limit, one ``run {...}`` JSON line per
run, and one ``summary {...}`` line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SHORT = [0, 1, 16, 17, 100, 161, 239, 240]   # chip_smoke.py's B4/B5 lens


def one(root):
    """Time both pool types of ``root``'s per-page kernel; one JSON dict."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_kernel)
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["paged_decode"])
    timer = chip_smoke.Timer(torch)
    out = {"root": root}
    for quantized, name in ((False, "paged_decode"), (True,
                                                      "paged_decode_q")):
        rec = chip_smoke.decode_phase(
            torch, timer, name, paged_decode_attention_kernel, 8, 15, SHORT,
            seed=1, quantized=quantized)
        out[name] = {k: rec[k] for k in (
            "ms", "graph_ms", "host_ms", "library_ms", "library_graph_ms",
            "bound_ms", "slot_rel_err", "max_abs_err")}
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
        for name in ("paged_decode", "paged_decode_q"):
            for key, val in run[name].items():
                summary.setdefault(f"{run['root']} {name} {key}",
                                   []).append(val)
        summary.setdefault(f"{run['root']} floor_graph_ms", []).append(
            run["floor_graph_ms"])
    print("summary " + json.dumps({"card": card, "runs": summary}),
          flush=True)


if __name__ == "__main__":
    main()
