#!/usr/bin/env python3
"""Train GPT-2 medium a few steps with the JAX package's ``TrainStep`` and
the port's, from the same parameters and batch, on the CPU, and print both
loss sequences: does the port's loss follow the reference's?

    JAX_PLATFORMS=cpu python3 tools/torch_gpt_loss_probe.py [--steps 6]
        [--batch 2] [--seq 64] [--dtypes float32,bfloat16]

Full width and depth (24 layers, hidden 1024, 16 heads, vocab 50304),
AdamW 3e-4 with global-norm clip 1.0 (``chip_smoke.py``'s training
settings), token ids uniform over the vocabulary from numpy seed 7, the
JAX model's initial parameters (``paddle.seed(0)``) moved into the port
through ``convert.gpt_params_from_numpy``; bfloat16 means bf16 parameters
with float32 masters on both sides. Each side runs in a process of its own
(about 6 GB each in float32); prints one ``losses {...}`` JSON line per
side and dtype and one ``verdict {...}`` line with the largest relative
difference per dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, CLIP, SEED = 3e-4, 1.0, 7


def run_side(side, dtype, steps, batch, seq, params):
    ids = np.random.default_rng(SEED).integers(0, 50304, (batch, seq))
    t = time.perf_counter()
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import paddle_tpu as paddle
        from paddle_tpu import nn as jnn
        from paddle_tpu import optimizer as jopt
        from paddle_tpu.models import gpt as jgpt
        paddle.seed(0)
        model = jgpt.GPT(jgpt.GPTConfig.gpt2_medium())
        if dtype == "bfloat16":
            model.to(dtype="bfloat16")
        np.savez(params, **{n: np.asarray(p._data.astype(jnp.float32))
                            for n, p in model.named_parameters()})
        opt = jopt.AdamW(learning_rate=LR, parameters=model.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
        step = paddle.jit.TrainStep(model, opt, lambda m, x: m.loss(x, x))
        losses = [float(step(paddle.to_tensor(ids)).numpy())
                  for _ in range(steps)]
    else:
        import torch
        from paddle_tpu.models.gpt import GPTConfig as JConfig
        from paddle_tpu_torch import AdamW, GPT, GPTConfig, TrainStep
        from paddle_tpu_torch.convert import gpt_params_from_numpy
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm
        td = getattr(torch, dtype)
        model = GPT(GPTConfig.gpt2_medium(), device="cpu", dtype=td)
        model.load_state_dict(gpt_params_from_numpy(
            dict(np.load(params)), JConfig.gpt2_medium(), dtype=td))
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(CLIP))
        step = TrainStep(model, opt, lambda m, x: m.loss(x, x))
        losses = [step(torch.from_numpy(ids)).item() for _ in range(steps)]
    print("losses " + json.dumps(dict(side=side, dtype=dtype, losses=losses,
                                      secs=time.perf_counter() - t)),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--params", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.side:
        run_side(a.side, a.dtypes, a.steps, a.batch, a.seq, a.params)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    verdict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in a.dtypes.split(","):
            params = os.path.join(tmp, f"gpt2_medium_{dtype}.npz")
            got = {}
            for side in ("jax", "torch"):
                r = subprocess.run(
                    [sys.executable, __file__, "--side", side, "--dtypes",
                     dtype, "--steps", str(a.steps), "--batch",
                     str(a.batch), "--seq", str(a.seq), "--params", params],
                    env=env, capture_output=True, text=True)
                line = next((x for x in r.stdout.splitlines()
                             if x.startswith("losses ")), None)
                if r.returncode or line is None:
                    sys.stderr.write(r.stderr)
                    return 1
                print(line, flush=True)
                got[side] = json.loads(line[len("losses "):])["losses"]
            verdict[dtype] = max(abs(x - y) / abs(y) for x, y in
                                 zip(got["torch"], got["jax"]))
    print("verdict " + json.dumps({"max_rel_diff": verdict}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
