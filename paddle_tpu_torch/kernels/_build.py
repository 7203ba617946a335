"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use into its own shared library with a plain
C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

``build_all()`` starts one ``nvcc`` per source together and waits for all,
so the build takes as long as the slowest file. ptxas's register and
shared-memory report for each kernel lands in ``_build/<name>.log``.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "paged_decode_split",
           "quant_matmul")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C entry points: every pointer and the stream as c_void_p, ints as c_int;
# each returns its cudaError_t as an int
SIGNATURES = {
    "flash_fwd": {
        # q, k, v, o, lse, B, Sq, Sk, Hq, Hk, D, causal, scale,
        # (batch, seq, head) strides of q, k, v, stream
        "flash_fwd_bf16": [_P] * 5 + [_I] * 7 + [_F] + [_L] * 9 + [_P],
    },
    "flash_bwd": {
        # q, k, v, do, lse, delta, dq, B, Sq, Sk, Hq, Hk, D, causal, scale,
        # (batch, seq, head) strides of q, k, v, do, stream
        "flash_bwd_dq_bf16": [_P] * 7 + [_I] * 7 + [_F] + [_L] * 12 + [_P],
        # q, k, v, do, lse, delta, dk, dv, then as above
        "flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 7 + [_F] + [_L] * 12
        + [_P],
    },
    "paged_decode": {
        # q, k_pool, v_pool, tables, lens, out, B, Hq, Hk, D, bs, mbps,
        # scale, stream
        "paged_decode_bf16": [_P] * 6 + [_I] * 6 + [_F, _P],
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, then as
        # paged_decode_bf16
        "paged_decode_i8": [_P] * 8 + [_I] * 6 + [_F, _P],
    },
    "paged_decode_split": {
        # q, k_pool, v_pool, tables, lens, acc, m, l, B, Hq, Hk, D, bs,
        # mbps, chunk_pages, chunks_per_split, nsplit, scale, stream
        "paged_decode_split_bf16": [_P] * 8 + [_I] * 9 + [_F, _P],
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, acc, m, l,
        # then as paged_decode_split_bf16
        "paged_decode_split_i8": [_P] * 10 + [_I] * 9 + [_F, _P],
        # acc, m, l, lens, out, B, Hq, Hk, D, nsplit, keys_per_split,
        # stream
        "paged_decode_merge_bf16": [_P] * 5 + [_I] * 6 + [_P],
    },
    "quant_matmul": {
        # x, w_int8, w_scales, y, workspace, M, N, K, k chunks per split,
        # stream
        "quant_matmul_bf16": [_P] * 5 + [_I] * 4 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on first use")
    return found


def lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")])
    return out.stat().st_mtime < newest


def _command(name):
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-lineinfo",
            "-o", str(lib_path(name)), str(SRC_DIR / f"{name}.cu")]


def build_all(names=SOURCES):
    """Compile every stale source, one ``nvcc`` each, all at once.
    Raises ``RuntimeError`` with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _stale(name):
            log = open(BUILD_DIR / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                _command(name), stdout=log, stderr=subprocess.STDOUT), log)
    failed = []
    for name, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((name, (BUILD_DIR / f"{name}.log").read_text()))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{text}" for n, text in failed))


def load(name):
    """The loaded library for source ``name``, building it if needed,
    with ``argtypes``/``restype`` set for each C entry point."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err, what):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
