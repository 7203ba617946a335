"""The flags this slice reads (mirrors ``paddle_tpu/core/flags.py``).

Each flag has a default, may be overridden by an environment variable of
the same name at import, and by ``set_flags`` at run time. Engines read
them once, at construction; attention reads ``FLAGS_flash_kernel`` at each
call.

- ``FLAGS_paged_kernel``: ``auto`` (default) launches the paged-decode
  CUDA kernels for CUDA tensors (their plain PyTorch version for CPU
  tensors); ``kernel`` is the same route named explicitly; ``dense`` forces
  the plain gather-then-attend version everywhere. It routes the int8
  weight matmul of ``quantization.ConvertedInt8Linear`` the same way, read
  when a layer is converted.
- ``FLAGS_flash_kernel``: ``auto`` (default) sends CUDA tensors through the
  flash forward/backward CUDA kernels and CPU tensors through their plain
  PyTorch versions; ``plain`` sends CUDA tensors to the plain pair too.
  The A/B switch of the JAX package's ``PADDLE_FLASH_FORCE``;
  ``chip_smoke.py`` uses it to hold the whole model's kernel route against
  the plain one.
- ``FLAGS_kv_cache_dtype``: KV pool storage, read when an engine is
  built: ``""`` (default) keeps the pools in the compute dtype; ``int8``
  stores int8 rows with a float32 scale per (token, kv head) row.
"""

from __future__ import annotations

import os

_DEFAULTS = {
    "FLAGS_paged_kernel": "auto",
    "FLAGS_flash_kernel": "auto",
    "FLAGS_kv_cache_dtype": "",
}

_values = {name: os.environ.get(name, default)
           for name, default in _DEFAULTS.items()}


def flag(name):
    if name not in _values:
        raise ValueError(f"unknown flag {name!r}")
    return _values[name]


def set_flags(flags: dict):
    for name in flags:
        if name not in _values:
            raise ValueError(f"unknown flag {name!r}")
    for name, value in flags.items():
        _values[name] = str(value)

