"""PyTorch port: fp8 training (``amp.fp8``) against the JAX package on the
CPU.

Inputs come from numpy with a seed and go to both packages; the port's
fp8 product takes its plain route here (dequantized float32 operands,
``torch.matmul``). Quantization must agree bit for bit. Products of the
same quantized operands differ only in float32 summation order: rtol
1e-5. Delayed-scaling histories and scales are amax values and their
float32 quotients: rtol 1e-6. Whole models stack a few products, each
quantized from the previous one's output, so a last-ulp difference can
move an element across an fp8 rounding boundary: losses at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.amp import fp8 as jfp8
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import GPT, GPTConfig, Llama, LlamaConfig, TrainStep
from paddle_tpu_torch.amp import fp8
from paddle_tpu_torch.amp.fp8 import (DelayedScaling, FP8Linear,
                                      convert_to_fp8, fp8_autocast)
from paddle_tpu_torch.convert import (gpt_params_from_numpy,
                                      llama_params_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
from paddle_tpu_torch.optimizer import AdamW

RTOL = 1e-5
SCALE_RTOL = 1e-6
MODEL_RTOL = 1e-4


def _jnp(t):
    return np.asarray(t.numpy())


def _named(model):
    """A JAX model's parameters and buffers as float32 numpy arrays."""
    return {n: np.asarray(t._data.astype(jnp.float32)) for n, t in
            [*model.named_parameters(), *model.named_buffers()]}


@pytest.mark.parametrize("dtype,fp8_max,jdtype", [
    (torch.float8_e4m3fn, fp8.E4M3_MAX, jnp.float8_e4m3fn),
    (torch.float8_e5m2, fp8.E5M2_MAX, jnp.float8_e5m2)])
def test_quantize_bit_for_bit(dtype, fp8_max, jdtype):
    """x * (1 / scale), clamp, cast: the same bits as the JAX package's
    ``_quantize`` over 2^-17..2^8 of both signs, saturating values too."""
    rng = np.random.default_rng(0)
    x = (rng.choice([-1.0, 1.0], 20000) * 2.0 ** rng.uniform(-17, 8, 20000)
         ).astype(np.float32)
    scale = np.float32(0.37)
    got = fp8._quantize(torch.from_numpy(x), torch.tensor(scale), fp8_max,
                        dtype)
    ref = jfp8._quantize(jnp.asarray(x), jnp.asarray(scale), fp8_max,
                         jdtype)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(ref).view(np.uint8))


@pytest.mark.parametrize("shape,wdtype", [((16, 32, 48), "float32"),
                                          ((2, 7, 32, 16), "float32"),
                                          ((16, 32, 48), "bfloat16")])
def test_scaled_fp8_matmul_forward_and_backward(shape, wdtype):
    """The forward, dx and dW against the JAX package's custom VJP: e5m2
    gradient with current scaling, products of the saved fp8 operands,
    cotangents in the primal dtypes (bf16 in, bf16 grads out). 2 x 7 rows
    also exercise dW's zero padding of M to a multiple of 16."""
    *lead, k, n = shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.3
    g = rng.standard_normal((*lead, n)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jw = paddle.to_tensor(w, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w)
    if wdtype == "bfloat16":
        jx = paddle.to_tensor(jnp.asarray(x, jnp.bfloat16),
                              stop_gradient=False)
        jw = paddle.to_tensor(jnp.asarray(w, jnp.bfloat16),
                              stop_gradient=False)
        tx = torch.from_numpy(x).bfloat16().requires_grad_()
        tw = tw.bfloat16()
    tw.requires_grad_()
    jy = jfp8.scaled_fp8_matmul(jx, jw)
    jy.backward(paddle.to_tensor(jnp.asarray(g, jy._data.dtype)))
    ty = fp8.scaled_fp8_matmul(tx, tw)
    ty.backward(torch.from_numpy(g).to(ty.dtype))
    assert ty.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    assert tw.grad.dtype == tw.dtype
    rtol = RTOL if wdtype == "float32" else 1e-2  # one bf16 rounding
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               _jnp(jy).astype(np.float32), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               _jnp(jx.grad).astype(np.float32), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               _jnp(jw.grad).astype(np.float32), rtol=rtol,
                               atol=rtol)


def _pair(k=32, n=16, recipe=None, jrecipe=None, seed=2):
    """A JAX FP8Linear and the port's with the same weight and bias."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.2
    b = rng.standard_normal((n,)).astype(np.float32)
    jl = jfp8.FP8Linear(k, n, recipe=jrecipe)
    jl.weight._rebind(jnp.asarray(w))
    jl.bias._rebind(jnp.asarray(b))
    tl = FP8Linear(k, n, bias=True, device="cpu", recipe=recipe)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


def _buffers_match(jl, tl):
    for name in ("fp8_amax_x", "fp8_amax_w", "fp8_scale_x", "fp8_scale_w"):
        np.testing.assert_allclose(getattr(tl, name).numpy(),
                                   _jnp(getattr(jl, name)),
                                   rtol=SCALE_RTOL, err_msg=name)


@pytest.mark.parametrize("algo", ["max", "most_recent"])
def test_fp8_linear_three_training_forwards(algo):
    """Histories roll newest first, each scale reads the history before
    this step's amax (an empty history falls back to the current amax),
    margin 1 doubles it; outputs, histories and scales equal the JAX
    layer's after every forward."""
    jl, tl = _pair(recipe=DelayedScaling(margin=1, amax_history_len=4,
                                         amax_compute_algo=algo),
                   jrecipe=jfp8.DelayedScaling(margin=1, amax_history_len=4,
                                               amax_compute_algo=algo))
    jl.train()
    tl.train()
    rng = np.random.default_rng(3)
    for amp_ in (2.0, 8.0, 0.5):
        x = (rng.standard_normal((3, 5, 32)) * amp_).astype(np.float32)
        jy = jl(paddle.to_tensor(x))
        ty = tl(torch.from_numpy(x))
        np.testing.assert_allclose(ty.detach().numpy(), _jnp(jy),
                                   rtol=RTOL, atol=RTOL)
        _buffers_match(jl, tl)
    assert tl.fp8_amax_x[3] == 0.0 and tl.fp8_amax_x[2] > 0.0


def test_eval_freezes_histories_and_scales():
    jl, tl = _pair()
    x = np.random.default_rng(4).standard_normal((4, 32)).astype(np.float32)
    tl(torch.from_numpy(x))
    jl(paddle.to_tensor(x))
    before = {n: b.clone() for n, b in tl.named_buffers()}
    jl.eval()
    tl.eval()
    jy = jl(paddle.to_tensor(x * 9.0))
    ty = tl(torch.from_numpy(x * 9.0))
    for n, b in tl.named_buffers():
        assert torch.equal(b, before[n]), n
    _buffers_match(jl, tl)
    # frozen scales: 9x the history's amax saturates at +-448, as there
    np.testing.assert_allclose(ty.detach().numpy(), _jnp(jy), rtol=RTOL,
                               atol=RTOL)


def test_autocast_off_and_recipe_override():
    jl, tl = _pair()
    x = np.random.default_rng(5).standard_normal((4, 32)).astype(np.float32)
    with fp8_autocast(enabled=False):
        ty = tl(torch.from_numpy(x))
    with jfp8.fp8_autocast(enabled=False):
        jy = jl(paddle.to_tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), _jnp(jy), atol=1e-5)
    exact = x @ tl.weight.detach().numpy().T + tl.bias.detach().numpy()
    np.testing.assert_allclose(ty.detach().numpy(), exact, atol=1e-5)
    assert torch.equal(tl.fp8_amax_x, torch.zeros(16))  # nothing rolled
    with fp8_autocast(recipe=DelayedScaling(amax_history_len=16, margin=2)):
        ty = tl(torch.from_numpy(x))
    with jfp8.fp8_autocast(recipe=jfp8.DelayedScaling(amax_history_len=16,
                                                      margin=2)):
        jy = jl(paddle.to_tensor(x))
    _buffers_match(jl, tl)
    assert float(tl.fp8_scale_x) == pytest.approx(
        float(np.abs(x).max()) * 4.0 / fp8.E4M3_MAX, rel=SCALE_RTOL)
    np.testing.assert_allclose(ty.detach().numpy(), _jnp(jy), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("include,exclude", [
    (None, ("lm_head",)), (("attn",), ("out_proj",)),
    (lambda name: name.endswith("fc_in"), ())])
def test_convert_to_fp8_include_exclude(include, exclude):
    """The same layers convert as in the JAX package; in place, the same
    Parameter objects; a second pass converts nothing more."""
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.tie_word_embeddings = False
    jm = jgpt.GPT(jcfg)
    jfp8.convert_to_fp8(jm, include=include, exclude=exclude)
    want = {n for n, m in jm.named_sublayers()
            if isinstance(m, jfp8.FP8Linear)}
    cfg = GPTConfig.tiny()
    cfg.tie_word_embeddings = False
    tm = GPT(cfg, device="cpu")
    params = {n: p for n, p in tm.named_parameters()}
    convert_to_fp8(tm, include=include, exclude=exclude)
    got = {n for n, m in tm.named_modules() if isinstance(m, FP8Linear)}
    assert got == want and got
    assert all(p is params[n] for n, p in tm.named_parameters())
    assert all(type(m) is Linear for n, m in tm.named_modules()
               if isinstance(m, Linear) and n not in got)
    convert_to_fp8(tm, exclude=("lm_head",))
    assert not isinstance(tm.lm_head, FP8Linear)


def _gpt_pair(dtype="float32", tie=True):
    jcfg = jgpt.GPTConfig.tiny()
    jcfg.use_fp8 = True
    jcfg.tie_word_embeddings = tie
    paddle.seed(0)
    jm = jgpt.GPT(jcfg)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    cfg = GPTConfig.tiny()
    cfg.use_fp8 = True
    cfg.tie_word_embeddings = tie
    tdtype = getattr(torch, dtype)
    tm = GPT(cfg, device="cpu", dtype=tdtype)
    tm.load_state_dict(gpt_params_from_numpy(_named(jm), cfg, dtype=tdtype))
    return jm, tm, cfg


def test_use_fp8_gpt_loss_and_grads(monkeypatch):
    """``use_fp8`` converts the block linears and not ``lm_head``, after
    the parameters are drawn (the same weights as without fp8); the tiny
    GPT's loss, gradients and rolled buffers against the JAX package's
    (its attention through the Pallas kernels in interpret mode)."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    cfg = GPTConfig.tiny()
    g1 = torch.Generator().manual_seed(7)
    plain = GPT(cfg, device="cpu", generator=g1)
    cfg8 = GPTConfig.tiny()
    cfg8.use_fp8 = True
    g2 = torch.Generator().manual_seed(7)
    f8 = GPT(cfg8, device="cpu", generator=g2)
    for (n, a), b in zip(plain.named_parameters(), f8.parameters()):
        assert torch.equal(a, b), n

    jm, tm, cfg = _gpt_pair(tie=False)
    assert isinstance(tm.h[1].mlp.fc_out, FP8Linear)
    assert not isinstance(tm.lm_head, FP8Linear)
    ids = np.random.default_rng(6).integers(0, 256, (2, 40)).astype(np.int64)
    jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
    jl.backward()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(_jnp(jl)), rtol=MODEL_RTOL)
    jgrads = {n: _jnp(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        ref = jgrads[n].T if g.ndim == 2 and not n.startswith("w") else \
            jgrads[n]
        # rel. to the largest gradient: a flipped fp8 rounding moves one
        # element by one e5m2 step of the gradient's scale
        err = np.abs(g - ref).max() / np.abs(ref).max()
        assert err < 1e-3, (n, err)
    jb = dict(jm.named_buffers())
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _jnp(jb[n]), rtol=SCALE_RTOL,
                                   err_msg=n)


def test_use_fp8_llama_forward_and_eval_scales():
    """``LlamaConfig.use_fp8`` converts the seven projections of every
    layer, not the head; logits against the JAX package's in eval mode
    (frozen: an empty history scales by the current amax) and after one
    training forward (the histories filled, then frozen)."""
    jcfg = jllama.LlamaConfig.tiny()
    jcfg.use_fp8 = True
    paddle.seed(0)
    jm = jllama.Llama(jcfg)
    cfg = LlamaConfig.tiny()
    cfg.use_fp8 = True
    tm = Llama(cfg, device="cpu")
    tm.load_state_dict(llama_params_from_numpy(_named(jm), cfg))
    n8 = [n for n, m in tm.named_modules() if isinstance(m, FP8Linear)]
    assert len(n8) == 7 * cfg.num_layers and "lm_head" not in n8
    ids = np.random.default_rng(8).integers(0, 256, (2, 13)).astype(np.int64)
    jm.train()
    tm.train()
    jm(paddle.to_tensor(ids))
    tm(torch.from_numpy(ids))
    jm.eval()
    tm.eval()
    for probe in (ids, ids[:, :5]):
        ref = _jnp(jm(paddle.to_tensor(probe)))
        out = tm(torch.from_numpy(probe)).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=MODEL_RTOL,
                                   atol=MODEL_RTOL)
    jb = dict(jm.named_buffers())
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _jnp(jb[n]), rtol=SCALE_RTOL,
                                   err_msg=n)


@pytest.mark.parametrize("dtype,rtol", [("float32", MODEL_RTOL),
                                        ("bfloat16", 1e-2)])
def test_gpt_fp8_three_train_steps_match_jax_train_step(monkeypatch, dtype,
                                                        rtol):
    """Three ``TrainStep``s of the tiny fp8 GPT (AdamW, clip 1.0) from the
    same parameters, buffers and batch: losses at each step and the
    parameters after the third. bf16 rounds at other places in the two
    frameworks (XLA also keeps excess precision inside its fused bf16
    ops): rtol 1e-2 on its losses. A parameter whose Adam step flipped
    sign (its gradient near 0) moves by up to 2 lr a step: parameters
    within 6 lr, and (float32) within 1e-4 for 99 % of the elements. In
    float32 the fp8 buffers, rolled once per forward in place, equal the
    JAX step's (the JAX package's ``to(bfloat16)`` casts them to bf16;
    the port keeps them float32)."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, tm, cfg = _gpt_pair(dtype)
    ids = np.random.default_rng(9).integers(0, 256, (2, 40)).astype(np.int64)
    lr = 1e-3
    jo = jopt.AdamW(learning_rate=lr, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jstep = paddle.jit.TrainStep(jm, jo, lambda m, x: m.loss(x, x))
    jl = [float(_jnp(jstep(paddle.to_tensor(ids)))) for _ in range(3)]
    to = AdamW(learning_rate=lr, parameters=tm.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, to, lambda m, x: m.loss(x, x))
    tl = [tstep(torch.from_numpy(ids)).item() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[2] < tl[0]
    h = tm.h[0].attn.qkv_proj.fp8_amax_x
    assert h.dtype == torch.float32
    assert (h[:3] > 0).all() and (h[3:] == 0).all()
    if dtype == "float32":
        jb = dict(jm.named_buffers())
        for n, b in tm.named_buffers():
            np.testing.assert_allclose(b.numpy(), _jnp(jb[n]),
                                       rtol=SCALE_RTOL, err_msg=n)
    jp = {n: np.asarray(p._data.astype(jnp.float32))
          for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        a = p.detach().float().numpy()
        ref = jp[n].T if a.ndim == 2 and not n.startswith("w") else jp[n]
        diff = np.abs(a - ref)
        assert diff.max() <= 6 * lr, (n, diff.max())
        if dtype == "float32":
            q99 = np.quantile(diff, 0.99)
            assert q99 <= 1e-4, (n, q99)


def test_use_fp8_llama_served_matches_jax_engine():
    """The tiny fp8 Llama, its scales calibrated by one training-mode
    forward on both sides and frozen (eval), served by both packages'
    engines from the same prompts (staggered, greedy, float32): the same
    tokens, and no buffer moves while serving. In float32 the paged and
    dense paths differ by float32 rounding only, too little to move an
    element across an e4m3 rounding boundary."""
    from paddle_tpu.inference.paged import (
        ContinuousBatchingEngine as JaxEngine)
    from paddle_tpu_torch import ContinuousBatchingEngine
    jcfg = jllama.LlamaConfig.tiny()
    jcfg.use_fp8 = True
    paddle.seed(0)
    jm = jllama.Llama(jcfg)
    cfg = LlamaConfig.tiny()
    cfg.use_fp8 = True
    tm = Llama(cfg, device="cpu")
    tm.load_state_dict(llama_params_from_numpy(_named(jm), cfg))
    calib = np.random.default_rng(10).integers(0, 256, (1, 24)).astype(
        np.int64)
    jm.train()
    tm.train()
    jm(paddle.to_tensor(calib))
    with torch.no_grad():
        tm(torch.from_numpy(calib))
    jm.eval()
    tm.eval()
    frozen = {n: b.clone() for n, b in tm.named_buffers()}
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int64)
               for n in (9, 5, 14)]
    kw = dict(max_batch=3, block_size=8, max_seq_len=64, temperature=0.0)

    def drive(engine):
        rids = [engine.add_request(p, max_new_tokens=10) for p in prompts]
        out = engine.run_to_completion()
        return [list(map(int, out[r])) for r in rids]

    ref = drive(JaxEngine(jm, dtype=jnp.float32, **kw))
    out = drive(ContinuousBatchingEngine(tm, dtype=torch.float32, **kw))
    assert out == ref
    for n, b in tm.named_buffers():
        assert torch.equal(b, frozen[n]), n
