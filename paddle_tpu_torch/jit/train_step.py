"""``TrainStep`` (mirrors ``paddle_tpu/jit/__init__.py:344-494``).

The JAX package compiles forward, backward, clip and update into one
donated XLA program. Here the step is eager PyTorch (no ``torch.compile``,
no CUDA graph yet), in the same order: (1) the optimizer's global step
advances, (2) ``step_fn(model, *batch)`` runs the forward, (3) ``backward``,
(4) the grads are clipped in their own dtype, (5) the update runs on the
float32 master (or on the float32 parameter) at the optimizer's
``get_lr()`` of this call (a scheduler's ``last_lr``, as the JAX step
passes ``lr`` in), (6) ``master.to(param dtype)`` is written back into
the parameter, (7) the grads are dropped, (8) the loss comes back as a
tensor, with no host sync. Buffers that the forward updates (the fp8
layers' amax histories and scales) change in place, once per forward.
The caller steps a scheduler between calls.
"""

from __future__ import annotations


class TrainStep:
    """``step_fn(model, *batch) -> loss`` (or ``-> (loss, aux...)``)."""

    def __init__(self, model, optimizer, step_fn=None):
        self._model = model
        self._opt = optimizer
        self._step_fn = step_fn or (lambda m, *batch: m(*batch))

    def __call__(self, *batch):
        opt = self._opt
        opt._global_step += 1
        out = self._step_fn(self._model, *batch)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        loss.backward()
        opt._update_all()
        opt.clear_grad()
        if isinstance(out, (tuple, list)):
            return (loss.detach(),) + tuple(out[1:])
        return loss.detach()
