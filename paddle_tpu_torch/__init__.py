"""PyTorch/CUDA port of paddle_tpu, slice by slice.

This package holds the Llama serving path (continuous batching over a
paged KV cache, bf16 or int8, with bf16 or int8 weights through
``quantization.QAT``, behind the serving frontend
``serving.ServingEngine`` with its scheduler, prefix cache, overload
control, self-speculative decode, per-request cost accounting and
tracing) and the GPT training path (``GPT`` trained by ``jit.TrainStep``
with the ``optimizer`` family, its ``optimizer.lr`` schedulers and fp32
master weights; mixed precision through ``amp`` (``auto_cast``,
``decorate``, ``GradScaler``) and fp8 through ``amp.fp8`` or
``use_fp8=True``), with hand-written
Hopper (sm_90a) CUDA kernels for the flash-attention forward and
backward, the paged-decode attention over bf16 and int8 pools and the
int8 weight matmul. Its layout follows ``paddle_tpu`` (``core/``,
``nn/``, ``models/``, ``optimizer/``, ``amp/``, ``jit/``, ``inference/``,
``serving/``, ``profiler/``, ``quantization/``, ``kernels/``) so each
module's counterpart is found under the same path.

It imports torch, numpy and the standard library only. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without an explicit device they raise.
"""

from . import amp, optimizer
from .inference.paged import ContinuousBatchingEngine, PagedKVCache
from .jit import TrainStep
from .models.gpt import GPT, GPTConfig
from .models.llama import Llama, LlamaConfig
from .optimizer import AdamW
from .serving import ServingEngine

__all__ = ["AdamW", "ContinuousBatchingEngine", "GPT", "GPTConfig", "Llama",
           "LlamaConfig", "PagedKVCache", "ServingEngine", "TrainStep",
           "amp", "optimizer"]
