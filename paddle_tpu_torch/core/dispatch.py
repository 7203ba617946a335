"""The functional ops' post hook (mirrors ``_post_op_hooks`` of
``paddle_tpu/core/dispatch.py:964-1001``).

The JAX package runs every op through one dispatcher, whose post hook
does three things for each op: a profiler ``Operator`` span (real
duration, the dispatch path, shapes and dtypes under ``record_shapes``),
the AMP op-stats record (``amp.debugging.record_op``) and the NaN/Inf
check (``amp.debugging.check_array``, under ``FLAGS_check_nan_inf``).
The port has no dispatcher: its functional ops (the ones that consult the
AMP lists by op name) are wrapped by ``op_hook(name)``, under the JAX
package's op names: ``linear``, ``matmul``, ``softmax``, ``rms_norm``,
``layer_norm``, ``swiglu``, ``gelu``, ``cross_entropy``, ``conv2d``,
``embedding`` and ``flash_attention`` (``scaled_dot_product_attention``
and ``flash_attention`` of ``kernels/flash_attention.py``). Elementwise
tensor arithmetic runs as plain PyTorch and is not hooked, so the port
checks fewer ops than the JAX package's eager dispatcher does.

Disarmed (no recording profiler, no op-stats collection, the flag off)
the hook reads one attribute. ``refresh()`` re-arms it: ``set_flags``
calls it, and so do the profiler and the op-stats toggles.
"""

from __future__ import annotations

import functools
import time

from . import flags as _flags

__all__ = ["op_hook", "refresh", "HOOKS"]


class _Hooks:
    armed = False       # any of the three below
    naninf = False      # FLAGS_check_nan_inf
    stats = None        # amp.debugging.record_op while collecting
    recorder = None     # the profiler's host recorder while recording


HOOKS = _Hooks()


def refresh():
    """Recompute whether the post hook runs: the flag, the op-stats
    toggle (``amp.debugging`` sets ``HOOKS.stats``) and the profiler's
    recorder (it sets ``HOOKS.recorder`` while recording)."""
    HOOKS.naninf = bool(_flags.flag("FLAGS_check_nan_inf"))
    HOOKS.armed = HOOKS.naninf or HOOKS.stats is not None or \
        HOOKS.recorder is not None


_flags.on_set(refresh)
refresh()  # the flag may come from the environment


def _post_op_hooks(name, outs, begin):
    """The profiler span, the op-stats record and the NaN/Inf check of
    one op's outputs (the JAX package's order)."""
    rec = HOOKS.recorder
    if rec is not None:
        end = time.perf_counter_ns() / 1000.0
        args = {"path": "eager"}
        if rec.record_shapes:
            args["shapes"] = [list(getattr(o, "shape", ())) for o in outs]
            args["dtypes"] = [str(getattr(o, "dtype", "?")) for o in outs]
        rec.record(name, begin / 1000.0, end, "Operator", args)
    stats = HOOKS.stats
    if stats is not None:
        for o in outs:
            if hasattr(o, "dtype"):
                stats(name, o.dtype)
                break
    if HOOKS.naninf:
        from ..amp import debugging
        for o in outs:
            if hasattr(o, "dtype"):
                debugging.check_array(name, o)


def op_hook(name):
    """Decorate a functional op: disarmed, one attribute read; armed, its
    outputs go through ``_post_op_hooks`` under ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not HOOKS.armed:
                return fn(*args, **kwargs)
            begin = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            _post_op_hooks(name, out if isinstance(out, (tuple, list))
                           else (out,), begin)
            return out
        return run
    return deco
