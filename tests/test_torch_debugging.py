"""PyTorch port: the numerics checker (``amp/debugging.py``) and the
functional ops' post hook (``core/dispatch.py``) on the CPU.

- ``check_numerics`` gives the JAX package's NaN, Inf and zero counts on
  the same arrays.
- The tensor checker on a tiny Llama forward: armed, every hooked op's
  output is checked (``amp.check_naninf.checked`` moves, ``flagged``
  stays); a NaN weight raises ``FloatingPointError`` naming the op at
  level 0 and warns at level 1.
- Op stats by dtype for the hooked ops; disarmed, the hook leaves every
  counter silent.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import Llama, LlamaConfig
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.core import dispatch, get_flags, set_flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import metrics


@pytest.fixture(autouse=True)
def restore_flags():
    saved = get_flags(["FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"])
    yield
    set_flags(saved)
    if dbg._op_stats is not None:
        dbg.disable_operator_stats_collection()
    assert not dispatch.HOOKS.armed


def _counts():
    return {k: v for k, v in metrics.snapshot("amp.").items()
            if k.startswith(("amp.check_naninf.", "amp.op_calls."))}


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_check_numerics_counts_match(dtype):
    a = np.random.default_rng(0).standard_normal((5, 7)).astype(dtype)
    a[0, :3] = np.nan
    a[1, 2] = np.inf
    a[2, 4] = -np.inf
    a[3, :5] = 0
    got = [int(t) for t in dbg.check_numerics(torch.from_numpy(a))]
    want = [int(t.numpy()) for t in jdbg.check_numerics(
        paddle.to_tensor(a))]
    assert got == want == [3, 2, 5]
    assert all(t.dtype == torch.int64 for t in
               dbg.check_numerics(torch.from_numpy(a)))


def _tiny(seed=0):
    torch.manual_seed(seed)
    m = Llama(LlamaConfig.tiny(), device="cpu",
              generator=torch.Generator().manual_seed(seed))
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (2, 9)).astype(np.int64))
    return m, ids


def test_checker_checks_every_hooked_op_and_flags_none():
    m, ids = _tiny()
    before = _counts()
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig())
    assert get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    assert dispatch.HOOKS.armed
    try:
        out = m(ids)
    finally:
        dbg.disable_tensor_checker()
    after = _counts()
    # per layer: 2 rms_norm, 7 linear, 1 flash_attention, 1 swiglu; then
    # the embedding, the final norm and the head
    n_layers = m.config.num_layers
    assert after["amp.check_naninf.checked"] - \
        before["amp.check_naninf.checked"] == 11 * n_layers + 3
    assert after["amp.check_naninf.flagged"] == \
        before["amp.check_naninf.flagged"]
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("level", [0, 1])
def test_a_nan_weight_raises_or_warns_naming_the_op(level):
    m, ids = _tiny()
    with torch.no_grad():
        m.layers[0].self_attn.q_proj.weight[0, 0] = float("nan")
    flagged = metrics.counter("amp.check_naninf.flagged").value
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(debug_mode=level))
    try:
        if level == 0:
            with pytest.raises(FloatingPointError, match="'linear'"):
                m(ids)
        else:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                m(ids)
            msgs = [str(x.message) for x in w]
            assert any("'linear'" in s and "NaN/Inf" in s for s in msgs)
    finally:
        dbg.disable_tensor_checker()
    assert metrics.counter("amp.check_naninf.flagged").value > flagged


def test_op_stats_by_dtype():
    x = torch.randn(3, 8)
    w = torch.randn(4, 8)
    before = _counts()
    with dbg.collect_operator_stats():
        F.linear(x, w)
        F.linear(x.bfloat16(), w.bfloat16())
        F.softmax(x.half())
        F.rms_norm(x, torch.ones(8))
        F.embedding(torch.tensor([1, 2]), w)
        stats = dict(dbg._op_stats)
    after = _counts()
    assert stats["linear"] == {"fp32": 1, "fp16": 0, "bf16": 1, "other": 0}
    assert stats["softmax"]["fp16"] == 1
    assert stats["rms_norm"]["fp32"] == 1
    assert stats["embedding"]["fp32"] == 1
    assert after["amp.op_calls.fp32"] - before["amp.op_calls.fp32"] == 3
    assert after["amp.op_calls.bf16"] - before["amp.op_calls.bf16"] == 1


def test_the_disarmed_hook_leaves_counters_silent():
    m, ids = _tiny()
    assert not dispatch.HOOKS.armed
    before = _counts()
    m(ids)
    F.linear(torch.randn(2, 3), torch.randn(4, 3))
    assert _counts() == before
    # set_flags re-arms it at once, and disarms it again
    set_flags({"FLAGS_check_nan_inf": True})
    assert dispatch.HOOKS.armed and dispatch.HOOKS.naninf
    set_flags({"FLAGS_check_nan_inf": False})
    assert not dispatch.HOOKS.armed
