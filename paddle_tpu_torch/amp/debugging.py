"""Numerics debugging (mirrors ``paddle_tpu/amp/debugging.py``):
``TensorCheckerConfig``, ``enable_tensor_checker`` /
``disable_tensor_checker``, ``check_numerics`` (NaN, Inf and zero
counts), ``check_array`` (the per-op check: raise or warn by
``FLAGS_check_nan_inf_level``) and the op-stats collection.

The checks run from the functional ops' post hook
(``core/dispatch.py``), which the port puts on ``linear``, ``matmul``,
``softmax``, ``rms_norm``, ``layer_norm``, ``swiglu``, ``gelu``,
``cross_entropy``, ``conv2d``, ``embedding`` and ``flash_attention``:
the port has no eager dispatcher for elementwise ops, so it checks fewer
ops than the JAX package does. Armed, ``check_array`` reads one bool back
from the device per op output (a host sync, as the JAX package's
``_host_read`` does).
"""

from __future__ import annotations

import collections
import warnings

import torch

from ..core import dispatch as _dispatch
from ..core import flags as flags_mod
from ..profiler import metrics as _metrics

_C_CHECKED = _metrics.counter("amp.check_naninf.checked")
_C_FLAGGED = _metrics.counter("amp.check_naninf.flagged")
_C_OP_CALLS = {k: _metrics.counter(f"amp.op_calls.{k}")
               for k in ("fp32", "fp16", "bf16", "other")}
_DTYPE_KEYS = {torch.float32: "fp32", torch.float16: "fp16",
               torch.bfloat16: "bf16"}

__all__ = ["TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "check_array",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "DebugMode"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    def __init__(self, enable=True, debug_mode=DebugMode.
                 CHECK_NAN_INF_AND_ABORT, output_dir=None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.checked_op_list = set(checked_op_list or ())
        self.skipped_op_list = set(skipped_op_list or ())

    def _apply(self):
        flags_mod.set_flags({
            "FLAGS_check_nan_inf": self.enable,
            "FLAGS_check_nan_inf_level": self.debug_mode})


_config = None


def enable_tensor_checker(checker_config=None):
    global _config
    _config = checker_config or TensorCheckerConfig()
    _config._apply()


def disable_tensor_checker():
    flags_mod.set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """The reference's debugging.py:362: (num_nan, num_inf, num_zero),
    int64 scalar tensors on the input's device."""
    t = torch.as_tensor(tensor)
    nan = torch.isnan(t).sum().to(torch.int64)
    inf = torch.isinf(t).sum().to(torch.int64)
    zero = (t == 0).sum().to(torch.int64)
    return nan, inf, zero


def check_array(name, arr):
    """The post hook's check of op ``name``'s output: a floating tensor
    with a NaN or an Inf raises ``FloatingPointError`` naming the op
    (``FLAGS_check_nan_inf_level`` 0) or warns (otherwise)."""
    if not torch.is_tensor(arr) or not arr.is_floating_point():
        return
    _C_CHECKED.inc()
    if bool(torch.isfinite(arr).all()):  # the host sync
        return
    _C_FLAGGED.inc()
    level = flags_mod.flag("FLAGS_check_nan_inf_level")
    msg = f"Operator {name!r} produced NaN/Inf output"
    if level == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(msg)
    warnings.warn(msg)


# -- op stats (the reference's debugging.py:482) -----------------------------
_op_stats = None


def enable_operator_stats_collection():
    global _op_stats
    _op_stats = collections.defaultdict(
        lambda: {"fp32": 0, "fp16": 0, "bf16": 0, "other": 0})
    _dispatch.HOOKS.stats = record_op
    _dispatch.refresh()


def disable_operator_stats_collection():
    global _op_stats
    stats = _op_stats
    _op_stats = None
    _dispatch.HOOKS.stats = None
    _dispatch.refresh()
    if stats:
        print("<{:-^120}>".format(" op list "))
        fmt = "{:<50} | {:<10} | {:<10} | {:<10} | {:<10}"
        print(fmt.format("OP Type", "FP16 Calls", "BF16 Calls",
                         "FP32 Calls", "Other Calls"))
        for op, c in sorted(stats.items()):
            print(fmt.format(op, c["fp16"], c["bf16"], c["fp32"],
                             c["other"]))
        print("<{:-^120}>".format(""))
    return stats


class collect_operator_stats:
    def __enter__(self):
        enable_operator_stats_collection()
        return self

    def __exit__(self, *exc):
        disable_operator_stats_collection()
        return False


def record_op(name, dtype):
    if _op_stats is None:
        return
    key = _DTYPE_KEYS.get(dtype, "other")
    _op_stats[name][key] += 1
    _C_OP_CALLS[key].inc()
