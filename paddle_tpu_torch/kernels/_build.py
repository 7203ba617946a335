"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use into its own shared library with a plain
C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

``build_all()`` starts one ``nvcc`` per source together and waits for all,
so the build takes as long as the slowest file. ptxas's register and
shared-memory report for each kernel lands in ``_build/<name>.log``.
Nothing here runs at import: the CPU tests import every module.

``thread_build_seconds()`` is the seconds the calling thread has spent
waiting on ``nvcc`` (the serving accountant bills it as compile time, as
the JAX package bills XLA compiles): 0 on the CPU, where nothing builds,
and 0 more once every kernel is built.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "paged_decode_split",
           "quant_matmul", "flash_simt", "paged_decode_simt_f32",
           "paged_decode_simt_f16", "paged_decode_simt_bf16",
           "quant_matmul_simt")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C entry points: every pointer and the stream as c_void_p, ints as c_int;
# each returns its cudaError_t as an int
SIGNATURES = {
    "flash_fwd": {
        # q, k, v, o, lse, q_seg, kv_seg, q_pos, kv_pos, kv tile bounds
        # (a workspace; the five NULL on the dense branch), B, Sq, Sk, Hq,
        # Hk, D, causal, scale, (batch, seq, head) strides of q, k, v,
        # stream
        "flash_fwd_bf16": [_P] * 10 + [_I] * 7 + [_F] + [_L] * 9 + [_P],
        # dtype (1 float16, 2 float32 as three bf16 pieces), then as
        # flash_fwd_bf16
        "flash_fwd_tc": [_I] + [_P] * 10 + [_I] * 7 + [_F] + [_L] * 9
        + [_P],
    },
    "flash_bwd": {
        # dtype (0 bf16, 1 float16, 2 float32 as three bf16 pieces), q, k,
        # v, do, lse, delta, dq, q_seg, kv_seg, q_pos, kv_pos, kv tile
        # bounds, B, Sq, Sk, Hq, Hk, D, causal, scale, (batch, seq, head)
        # strides of q, k, v, do, stream
        "flash_bwd_dq": [_I] + [_P] * 12 + [_I] * 7 + [_F] + [_L] * 12
        + [_P],
        # dtype, q, k, v, do, lse, delta, dk, dv, q_seg, kv_seg, q_pos,
        # kv_pos, q tile bounds, kv tile bounds, B, Sq, Sk, Hq, Hk, D,
        # causal, cluster size, then as above
        "flash_bwd_dkv": [_I] + [_P] * 14 + [_I] * 8 + [_F] + [_L] * 12
        + [_P],
        # x, out, B, S, H, D, padded D, (batch, seq, head) strides of x,
        # stream
        "flash_split_bf16x3": [_P] * 2 + [_I] * 5 + [_L] * 3 + [_P],
    },
    "paged_decode": {
        # q, k_pool, v_pool, tables, lens, out, B, Hq, Hk, D, bs, mbps,
        # chunk_pages, cluster, scale, stream
        "paged_decode_bf16": [_P] * 6 + [_I] * 8 + [_F, _P],
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, then as
        # paged_decode_bf16
        "paged_decode_i8": [_P] * 8 + [_I] * 8 + [_F, _P],
    },
    "paged_decode_split": {
        # as paged_decode_bf16 and paged_decode_i8 without chunk_pages
        # (clusters of up to 16 CTAs)
        "paged_decode_split_bf16": [_P] * 6 + [_I] * 7 + [_F, _P],
        "paged_decode_split_i8": [_P] * 8 + [_I] * 7 + [_F, _P],
    },
    "quant_matmul": {
        # x, w_int8, w_scales, y, workspace, M, N, K, k chunks per split,
        # stream
        "quant_matmul_bf16": [_P] * 5 + [_I] * 4 + [_P],
        # x, w_int8, w_scales, y, M, N, K, cluster size, stream (M <= 8)
        "quant_matmul_decode_bf16": [_P] * 4 + [_I] * 4 + [_P],
        # dtype (1 float16, 2 float32), then as quant_matmul_bf16 (x: the
        # three bf16 pieces [3, M, K] of a float32 x) and
        # quant_matmul_decode_bf16 (x: float32 itself)
        "quant_matmul_tc": [_I] + [_P] * 5 + [_I] * 4 + [_P],
        "quant_matmul_decode_tc": [_I] + [_P] * 4 + [_I] * 4 + [_P],
        # any K (the ragged loader), dtype 0 bf16, 1 float16, 2 float32:
        # as quant_matmul_tc with x's row stride in elements before the k
        # chunks per split, and as quant_matmul_decode_tc
        "quant_matmul_unaligned": [_I] + [_P] * 5 + [_I] * 5 + [_P],
        "quant_matmul_decode_unaligned": [_I] + [_P] * 4 + [_I] * 4 + [_P],
    },
    "flash_simt": {
        # dtype (0 float32, 1 float16), q, k, v, o, lse, q_seg, kv_seg,
        # q_pos, kv_pos (NULL on the dense branch), B, Sq, Sk, Hq, Hk, D,
        # causal, scale, (batch, seq, head) strides of q, k, v, stream
        "flash_simt_fwd": [_I] + [_P] * 9 + [_I] * 7 + [_F] + [_L] * 9
        + [_P],
        # dtype, q, k, v, do, lse, delta, dq, the four segment pointers,
        # B, Sq, Sk, Hq, Hk, D, causal, scale, strides of q, k, v, do,
        # stream
        "flash_simt_dq": [_I] + [_P] * 11 + [_I] * 7 + [_F] + [_L] * 12
        + [_P],
        # as flash_simt_dq with dk, dv in place of dq
        "flash_simt_dkv": [_I] + [_P] * 12 + [_I] * 7 + [_F] + [_L] * 12
        + [_P],
    },
    # the CUDA cores' decode, one source per query dtype: quantized, q,
    # k_pool, v_pool, k_scale, v_scale (NULL for float pools), tables,
    # lens, out, B, Hq, Hk, D, bs, mbps, the plan (cluster, group splits,
    # heads, lanes a key, warps, stages, copy width, K and V row strides:
    # ``simt_decode_plan``), scale, stream
    **{f"paged_decode_simt_{t}": {
        f"paged_decode_simt_{t}": [_I] + [_P] * 8 + [_I] * 15 + [_F, _P]}
       for t in ("f32", "f16", "bf16")},
    "quant_matmul_simt": {
        # dtype (0 float32, 1 float16, 2 bfloat16), x, w_int8, w_scales,
        # y, M, N, K, stream
        "quant_matmul_simt": [_I] + [_P] * 4 + [_I] * 3 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_built = threading.local()


def thread_build_seconds():
    """Cumulative seconds this thread has spent in ``build_all`` builds."""
    return getattr(_built, "secs", 0.0)


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
    t0 = time.perf_counter()
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
    if procs:
        _built.secs = thread_build_seconds() + time.perf_counter() - t0
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
