"""PyTorch port: the ``nn`` pieces of the ViT slice against the JAX package
on the CPU: the initializers and their fans, exact GELU, the containers'
names, ``conv2d`` over every padding form, ``cross_entropy`` over its
options and ``MultiHeadAttention`` with masks and caches.

Inputs come from numpy with a seed and go to both packages. Float32,
atol 1e-5 unless a test says otherwise; the initializer tests are
statistical (seeded, 1e5 draws or more).
"""

import math
import zlib
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as tinit

ATOL = 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (8, 3, 4, 4),
                                   (6, 2, 3), (4, 2, 3, 5, 2)])
def test_fans_match(shape):
    assert tinit._fans(shape) == jinit._fans(shape)


def test_linear_and_conv_fans_follow_the_jax_layout():
    """The port's Linear is [out, in]; its fans are the JAX package's
    [in, out] ones. A conv kernel [out, in, kh, kw] gives fan_in =
    in * kh * kw and fan_out = out * kh * kw."""
    lin = tnn.Linear(300, 100, weight_init=tinit.XavierNormal(),
                     device="cpu", generator=_gen(0))
    assert tuple(lin.weight.shape) == (100, 300)
    want = math.sqrt(2.0 / 400)
    assert abs(lin.weight.std().item() / want - 1) < 0.02
    assert tinit._fans((16, 3, 4, 5)) == (3 * 20, 16 * 20)
    conv = tnn.Conv2D(3, 64, 16, stride=16, device="cpu", generator=_gen(1))
    assert tuple(conv.weight.shape) == (64, 3, 16, 16)
    want = math.sqrt(2.0 / (3 * 256 + 64 * 256))
    assert abs(conv.weight.std().item() / want - 1) < 0.02
    assert torch.equal(conv.bias, torch.zeros(64))
    assert tnn.Conv2D(3, 8, 3, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("name,shape", [
    ("XavierNormal", (256, 512)), ("XavierUniform", (256, 512)),
    ("KaimingNormal", (512, 256)), ("XavierNormal", (64, 64, 5, 5)),
    ("Normal", (400, 300)), ("Uniform", (400, 300))])
def test_initializer_moments_match_jax(name, shape):
    """Same fans on both sides (the JAX shape handed to both), so the
    draws share their distribution: std within 2% of the formula's and of
    the JAX package's draw; Xavier's uniform stays inside its limit."""
    paddle.seed(0)
    j = np.asarray(getattr(jinit, name)()(shape, "float32"))
    t = getattr(tinit, name)()(shape, device="cpu", generator=_gen(0))
    assert tuple(t.shape) == shape and t.dtype == torch.float32
    fi, fo = tinit._fans(shape)
    want = {"XavierNormal": math.sqrt(2 / (fi + fo)),
            "XavierUniform": math.sqrt(6 / (fi + fo)) / math.sqrt(3),
            "KaimingNormal": math.sqrt(2) / math.sqrt(fi),
            "Normal": 1.0, "Uniform": 1 / math.sqrt(3)}[name]
    assert abs(t.std().item() / want - 1) < 0.02
    assert abs(j.std() / want - 1) < 0.02
    assert abs(t.mean().item()) < 0.01 * want * 10
    if name == "XavierUniform":
        lim = math.sqrt(6 / (fi + fo))
        assert t.abs().max().item() <= lim and j.max() <= lim
        assert t.abs().max().item() > 0.99 * lim


def test_truncated_normal_truncates_in_standard_units():
    """``TruncatedNormal(std=0.02)`` lies in [-0.04, 0.04] (a, b = -2, 2 in
    standard units), as the JAX package's does; its std is 0.02 times the
    standard normal's truncated at +-2 (0.8796), its mean 0. Over 1e5
    draws each side."""
    shape = (100, 1000)
    paddle.seed(3)
    j = np.asarray(jinit.TruncatedNormal(std=0.02)(shape, "float32"))
    t = tinit.TruncatedNormal(std=0.02)(shape, device="cpu",
                                        generator=_gen(3))
    phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
    z = math.erf(2 / math.sqrt(2))
    want_std = 0.02 * math.sqrt(1 - 4 * phi2 / z)
    for draw in (t.numpy(), j):
        assert draw.min() >= -0.04 and draw.max() <= 0.04
        assert draw.min() < -0.0395 and draw.max() > 0.0395
        assert abs(draw.std() / want_std - 1) < 0.01
        assert abs(draw.mean()) < 3e-4
    # shifted and in bf16: the draw is made in float32, then cast
    b = tinit.TruncatedNormal(mean=1.0, std=0.5)((4096,), device="cpu",
                                                 dtype=torch.bfloat16,
                                                 generator=_gen(4))
    assert b.dtype == torch.bfloat16
    assert b.float().min() >= 0.0 and b.float().max() <= 2.0
    assert torch.equal(tinit.Constant(0.5)((2, 3), device="cpu"),
                       torch.full((2, 3), 0.5))


def test_gelu_layer_is_the_exact_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(x, approximate=False))
    out = tnn.GELU()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    jout = JF.gelu(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(out, jout, atol=ATOL)
    tanh = tnn.GELU(approximate=True)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, np.asarray(jax.nn.gelu(x)), atol=ATOL)
    assert np.abs(tanh - out).max() > 1e-4


def _names(layer):
    return [n for n, _ in layer.named_parameters()]


def test_containers_name_their_layers_as_the_jax_package():
    paddle.seed(0)
    jseq = jnn.Sequential(jnn.Linear(4, 8), jnn.GELU(), jnn.Dropout(0.0),
                          jnn.Linear(8, 4))
    tseq = tnn.Sequential(tnn.Linear(4, 8, bias=True, device="cpu"),
                          tnn.GELU(), tnn.Dropout(0.0),
                          tnn.Linear(8, 4, bias=True, device="cpu"))
    assert _names(tseq) == _names(jseq) == [
        "0.weight", "0.bias", "3.weight", "3.bias"]
    assert _names(tseq[2:]) == _names(jseq[2:]) == ["1.weight", "1.bias"]
    assert isinstance(tseq[-1], tnn.Linear) and len(tseq) == 4
    pairs = [("fc", tnn.Linear(2, 2, device="cpu")), ("act", tnn.GELU())]
    assert _names(tnn.Sequential(*pairs)) == ["fc.weight"]
    assert _names(tnn.Sequential(OrderedDict(pairs))) == ["fc.weight"]
    assert _names(jnn.Sequential(("fc", jnn.Linear(2, 2)),
                                 ("act", jnn.GELU()))) == [
        "fc.weight", "fc.bias"]
    x = torch.randn(3, 4, generator=_gen(1))
    ref = tseq[3](tseq[1](tseq[0](x)))
    torch.testing.assert_close(tseq(x), ref)

    jl = jnn.LayerList([jnn.Linear(2, 2) for _ in range(3)])
    tl = tnn.LayerList([tnn.Linear(2, 2, device="cpu") for _ in range(3)])
    extra = tnn.Linear(2, 3, device="cpu")
    assert tl.append(extra) is tl
    jl.append(jnn.Linear(2, 3))
    assert [n for n in _names(tl)] == [n for n in _names(jl)
                                       if n.endswith("weight")]
    assert tl[-1] is extra and tl[3] is extra
    assert len(tl[1:3]) == 2 and isinstance(tl[1:3], tnn.LayerList)
    assert _names(tl[1:3]) == ["0.weight", "1.weight"]
    assert [tuple(m.weight.shape) for m in tl] == [(2, 2)] * 3 + [(3, 2)]


def _conv_case(padding, stride, dilation, groups, fmt, hw):
    rng = np.random.default_rng(zlib.crc32(repr(
        (padding, stride, dilation, groups, fmt)).encode()))
    x = rng.standard_normal((2, 4, *hw)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.standard_normal((6, 4 // groups, 3, 4)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("padding,stride,dilation,groups,fmt,hw", [
    (1, 1, 1, 1, "NCHW", (9, 11)),
    ([1, 2], 2, 1, 1, "NCHW", (9, 11)),
    ([[1, 0], [2, 1]], 1, 1, 1, "NCHW", (9, 11)),
    ([1, 0, 2, 1], 1, 1, 1, "NCHW", (9, 11)),
    ("SAME", 1, 1, 1, "NCHW", (9, 11)),
    ("SAME", 2, 1, 1, "NCHW", (9, 11)),      # odd input: lo != hi
    ("SAME", 3, 2, 1, "NCHW", (10, 13)),     # SAME resets dilation to 1
    ("VALID", 2, 1, 1, "NCHW", (9, 11)),
    (0, 1, 2, 1, "NCHW", (9, 11)),
    (1, 1, [2, 1], 2, "NCHW", (9, 11)),
    ("SAME", 2, 1, 2, "NHWC", (9, 11)),
    ([1, 2], 1, 1, 1, "NHWC", (8, 8)),
])
def test_conv2d_matches_jax(padding, stride, dilation, groups, fmt, hw):
    x, w, b = _conv_case(padding, stride, dilation, groups, fmt, hw)
    ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                    paddle.to_tensor(b), stride, padding, dilation, groups,
                    fmt).numpy()
    out = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride, padding, dilation, groups,
                    fmt)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-5)
    nob = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), None, stride,
                    padding, dilation, groups, fmt)
    axis = 1 if fmt == "NCHW" else 3
    bshape = [1, 1, 1, 1]
    bshape[axis] = 6
    np.testing.assert_allclose(nob.numpy() + b.reshape(bshape), ref,
                               atol=1e-4, rtol=1e-5)


def test_conv2d_layer_matches_jax_layer():
    paddle.seed(0)
    jc = jnn.Conv2D(3, 8, 4, stride=4)
    tc = tnn.Conv2D(3, 8, 4, stride=4, device="cpu")
    tc.load_state_dict({n: torch.from_numpy(np.array(p._data))
                        for n, p in jc.named_parameters()})
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(
        np.float32)
    np.testing.assert_allclose(tc(torch.from_numpy(x)).detach().numpy(),
                               jc(paddle.to_tensor(x)).numpy(), atol=1e-4)


def _ce_inputs(case):
    rng = np.random.default_rng(7)
    if case.get("axis", -1) == 1:
        logits = rng.standard_normal((3, 7, 4)).astype(np.float32) * 2
        label = rng.integers(0, 7, (3, 4)).astype(np.int64)
    else:
        logits = rng.standard_normal((6, 7)).astype(np.float32) * 2
        label = rng.integers(0, 7, (6,)).astype(np.int64)
        label[2] = -100
        if case.get("ignore_index") == 3:
            label[2] = label[4] = 3
    if case.get("soft_label"):
        p = rng.random((6, 7)).astype(np.float32)
        label = p / p.sum(-1, keepdims=True)
    if case.pop("trailing", False):
        label = label[:, None]
    if not case.get("use_softmax", True):
        e = np.exp(logits - logits.max(-1, keepdims=True))
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    weight = case.pop("weight", None)
    if weight:
        weight = rng.random(7).astype(np.float32) + 0.5
    return logits, label, weight


@pytest.mark.parametrize("case", [
    {}, {"reduction": "sum"}, {"reduction": "none"},
    {"weight": True}, {"weight": True, "reduction": "sum"},
    {"weight": True, "reduction": "none"},
    {"label_smoothing": 0.1}, {"label_smoothing": 0.2, "weight": True},
    {"ignore_index": 3}, {"trailing": True},
    {"axis": 1}, {"axis": 1, "reduction": "none"},
    {"soft_label": True}, {"soft_label": True, "weight": True},
    {"soft_label": True, "label_smoothing": 0.1, "reduction": "sum"},
    {"use_softmax": False},
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_cross_entropy_matches_jax(case):
    case = dict(case)
    logits, label, weight = _ce_inputs(case)
    jw = None if weight is None else paddle.to_tensor(weight)
    tw = None if weight is None else torch.from_numpy(weight)
    jx = paddle.to_tensor(logits)
    jx.stop_gradient = False
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), weight=jw, **case)
    tx = torch.from_numpy(logits).requires_grad_()
    tl = TF.cross_entropy(tx, torch.from_numpy(label), weight=tw, **case)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), atol=ATOL,
                               rtol=1e-6)
    jl.sum().backward()
    tl.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=ATOL)


def test_cross_entropy_hard_path_keeps_its_numbers():
    """The hard-label mean divides by the count of labels kept (at least
    1); every label ignored gives 0."""
    logits = torch.randn(4, 5, generator=_gen(0))
    label = torch.tensor([1, -100, 3, 0])
    logp = torch.log_softmax(logits, -1)
    want = -(logp[0, 1] + logp[2, 3] + logp[3, 0]) / 3
    torch.testing.assert_close(TF.cross_entropy(logits, label), want)
    assert TF.cross_entropy(logits, torch.full((4,), -100)).item() == 0.0


def _is_linear_weight(name):
    return name.endswith("_proj.weight")


def _mha_pair(seed=0, **kw):
    paddle.seed(seed)
    jm = jnn.MultiHeadAttention(32, 4, **kw)
    tm = tnn.MultiHeadAttention(32, 4, device="cpu", **kw)
    state = {n: torch.from_numpy(np.array(np.asarray(p._data).T
                                          if _is_linear_weight(n)
                                          else np.asarray(p._data)))
             for n, p in jm.named_parameters()}
    tm.load_state_dict(state, strict=True)
    return jm, tm


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


@pytest.mark.parametrize("mask", [None, "bool", "float", "masked_row"])
def test_multi_head_attention_matches_jax(mask):
    """Self-attention (S 5) and cross-attention over 7 keys with kdim 24 and
    vdim 20. A bool mask hides keys (True = visible); a float mask is added
    to the logits; a row whose keys are all masked is NaN on both sides."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 5, 32)).astype(np.float32)
    k = rng.standard_normal((2, 7, 24)).astype(np.float32)
    v = rng.standard_normal((2, 7, 20)).astype(np.float32)
    m = None
    if mask in ("bool", "masked_row"):
        m = rng.random((2, 1, 5, 7)) > 0.3
        m[..., 0] = True
        if mask == "masked_row":
            m[1, 0, 2, :] = False
    elif mask == "float":
        m = (rng.standard_normal((2, 4, 5, 7)) * 2).astype(np.float32)
    jm, tm = _mha_pair(kdim=24, vdim=20)
    jmask = None if m is None else paddle.to_tensor(m)
    tmask = None if m is None else torch.from_numpy(m)
    before = fa.sdpa_masked_plain.calls
    ref = jm(paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
             jmask).numpy()
    out = _np(tm(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), tmask))
    assert fa.sdpa_masked_plain.calls - before == (m is not None)
    assert out.shape == ref.shape == (2, 5, 32)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    if mask == "masked_row":
        assert np.isnan(out[1, 2]).all() and not np.isnan(out[0]).any()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    # self-attention, the kernels' route (no mask)
    jm, tm = _mha_pair(seed=1)
    ref = jm(paddle.to_tensor(q)).numpy()
    np.testing.assert_allclose(_np(tm(torch.from_numpy(q))), ref, atol=ATOL)


def test_multi_head_attention_caches_match_jax():
    """``Cache``: two calls append their k/v (5 then 3 positions);
    ``StaticCache``: k/v projected once from a memory of 7 positions."""
    rng = np.random.default_rng(12)
    x1 = rng.standard_normal((2, 5, 32)).astype(np.float32)
    x2 = rng.standard_normal((2, 3, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 7, 32)).astype(np.float32)
    jm, tm = _mha_pair(seed=2)
    jc = jm.gen_cache(paddle.to_tensor(x1))
    tc = tm.gen_cache(torch.from_numpy(x1))
    assert isinstance(tc, tnn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (2, 0, 4, 8)
    for x in (x1, x2):
        jo, jc = jm(paddle.to_tensor(x), paddle.to_tensor(x),
                    paddle.to_tensor(x), None, jc)
        to, tc = tm(torch.from_numpy(x), torch.from_numpy(x),
                    torch.from_numpy(x), None, tc)
        np.testing.assert_allclose(_np(to), jo.numpy(), atol=ATOL)
        np.testing.assert_allclose(_np(tc.k), jc.k.numpy(), atol=ATOL)
        np.testing.assert_allclose(_np(tc.v), jc.v.numpy(), atol=ATOL)
    assert tuple(tc.k.shape) == (2, 8, 4, 8)
    js = jm.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                      type=jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                      type=tnn.MultiHeadAttention.StaticCache)
    jo, js2 = jm(paddle.to_tensor(x2), None, None, None, js)
    to, ts2 = tm(torch.from_numpy(x2), None, None, None, ts)
    assert ts2 is ts
    np.testing.assert_allclose(_np(to), jo.numpy(), atol=ATOL)
