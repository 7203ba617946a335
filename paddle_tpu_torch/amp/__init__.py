"""Automatic mixed precision (mirrors ``paddle_tpu/amp/__init__.py``).

``auto_cast`` turns on one thread-local AMP state. The JAX package applies
its op lists in its op dispatcher (``paddle_tpu/core/dispatch.py:797``);
the port has no dispatcher, so the functional ops that have a counterpart
in the lists consult the state under the same op names: ``linear``,
``matmul`` and ``flash_attention`` (white list: floating inputs cast to the
AMP dtype) and ``layer_norm``, ``rms_norm``, ``cross_entropy`` and
``softmax`` (black list: cast to float32). These are the reference's
lists, not ``torch.autocast``'s. With AMP off an op reads one attribute.

``decorate(level="O2")`` casts every floating parameter to the AMP dtype
except ``LayerNorm``'s and turns on the optimizers' float32 masters.
``GradScaler`` is dynamic loss scaling with a per-optimizer READY ->
UNSCALED -> STEPPED state machine and one found-inf reduction on the
device, read on the host once per ``unscale_``. ``amp.fp8`` is the fp8
training path (``FP8Linear``, ``convert_to_fp8``); this module imports
nothing of the package, because ``nn.functional`` imports it (``amp.fp8``
imports ``nn`` and is loaded with the package's models).
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "AmpScaler",
           "OptimizerState", "amp_state", "white_list", "black_list",
           "is_bfloat16_supported", "is_float16_supported", "amp_guard",
           "amp_decorate", "fp8"]


# op-name lists (``paddle_tpu/amp/__init__.py:37-47``)
white_list = {
    "matmul", "linear", "conv2d", "conv1d", "conv3d", "einsum", "bmm",
    "flash_attention", "mm",
}
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "c_softmax_with_cross_entropy", "cross_entropy", "layer_norm",
    "log_softmax", "rms_norm", "batch_norm", "group_norm",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def cast_args(name, *args):
    """The O1 rule for op ``name`` (``amp_dispatch_pre``): floating tensors
    go to the AMP dtype for a white-list op, to float32 for a black-list
    op; anything else passes. Callers test ``_state.enabled`` first."""
    wl = (white_list | _state.custom_white) - _state.custom_black
    bl = (black_list | _state.custom_black) - _state.custom_white
    if name in wl:
        dt = _state.dtype
    elif name in bl:
        dt = torch.float32
    else:
        return args
    return tuple(a.to(dt) if torch.is_tensor(a) and a.is_floating_point()
                 and a.dtype != dt else a for a in args)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle_tpu/amp/__init__.py:89``. O1: per-op casts by the lists;
    O2: the caller also ``decorate``s the model to the AMP dtype."""
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = _dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


autocast = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """``paddle_tpu/amp/__init__.py:115``: O2 casts the models' floating
    parameters to ``dtype`` in place (the same ``Parameter`` objects;
    ``LayerNorm`` and ``excluded_layers`` keep theirs) and sets
    ``_multi_precision`` on the optimizers."""
    from ..nn import LayerNorm

    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = _dtype(dtype)
        excluded = tuple(excluded_layers or ()) + (LayerNorm,)
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, excluded):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for opt in opt_list:
        opt._multi_precision = True
    return ((models if single else model_list),
            (optimizers if opt_single else opt_list))


class OptimizerState:
    """The per-optimizer states of ``GradScaler`` (reference
    ``grad_scaler.py`` OptimizerState)."""

    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class GradScaler:
    """``paddle_tpu/amp/__init__.py:144``: dynamic loss scaling. With
    ``enable=False`` scale and unscale are the identity."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling and enable
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # id(optimizer) -> (OptimizerState, found_inf), cleared by update()
        self._opt_states = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Grads *= 1 / scale (in float32, back to each grad's dtype); one
        found-inf flag summed on the device over every grad, read once."""
        if not self._enable:
            return
        state = self._opt_states.get(id(optimizer))
        if state is not None and state[0] == OptimizerState.UNSCALED:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update().")
        if state is not None and state[0] == OptimizerState.STEPPED:
            raise RuntimeError("unscale_() is being called after step().")
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            nonfinite = (~torch.isfinite(g)).any()
            bad = nonfinite if bad is None else bad | nonfinite
            p.grad.copy_(g)
        found = bool(bad) if bad is not None else False
        # _found_inf ORs over every optimizer since the last update() (the
        # scale's rule); step() reads each optimizer's own verdict
        self._found_inf = self._found_inf or found
        self._opt_states[id(optimizer)] = (OptimizerState.UNSCALED, found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state = self._opt_states.get(id(optimizer))
        if state is not None and state[0] == OptimizerState.STEPPED:
            raise RuntimeError(
                "step() has already been called since the last update().")
        if state is None:
            self.unscale_(optimizer)
        found = self._opt_states[id(optimizer)][1]
        if not found:
            optimizer.step()
        self._opt_states[id(optimizer)] = (OptimizerState.STEPPED, found)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def update(self):
        self._opt_states.clear()
        found = self._found_inf
        self._found_inf = False
        if not self._dynamic:
            return
        if found:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


AmpScaler = GradScaler


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


# legacy-name aliases (reference amp/__init__.py re-exports)
amp_guard = auto_cast
amp_decorate = decorate
