"""PyTorch port: the package imports neither JAX nor the JAX package,
builds nothing at import, and its entry points refuse to fall back to the
CPU when no GPU exists."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from paddle_tpu_torch import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import resolve_device
from paddle_tpu_torch.vision.models import vit_l_16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_module_imports_without_jax_and_builds_nothing():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        import paddle_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        from paddle_tpu_torch.kernels import _build
        assert _build._libs == {}, _build._libs
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        for sub in ("optimizer", "jit", "models.gpt", "nn.fused_ce",
                    "nn.clip", "serving.frontend", "inference.paged",
                    "serving.spec", "profiler.tracing",
                    "profiler.accounting", "amp", "amp.fp8", "optimizer.lr",
                    "optimizer.adam", "optimizer.lbfgs", "regularizer",
                    "nn.initializer", "nn.conv", "nn.transformer",
                    "vision.models.vit"):
            assert "paddle_tpu_torch." + sub in names, sub
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_layers_and_vit_default_to_cuda(monkeypatch):
    """A layer or a ViT built without a device is a CUDA one: without a
    GPU it raises instead of landing on the CPU; ``device="cpu"`` asks
    for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: nn.Linear(4, 4), lambda: nn.Embedding(4, 4),
                  lambda: nn.LayerNorm(4), lambda: nn.RMSNorm(4),
                  lambda: nn.Conv2D(3, 4, 2),
                  lambda: nn.MultiHeadAttention(8, 2),
                  lambda: vit_l_16(num_classes=1000)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert nn.Linear(4, 4, device="cpu").weight.device.type == "cpu"
    assert nn.Conv2D(3, 4, 2, device="cpu").weight.device.type == "cpu"
