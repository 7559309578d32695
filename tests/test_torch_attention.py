"""The port's causal attention against the JAX package's, on the CPU.

- K1: ``splash_attention_plain`` (the plain version of the port's splash
  kernels, forward and backward) against ``splash_attention_tpu`` run in
  Pallas interpret mode, one query/key tile and several
  (``TORCHFT_TPU_SPLASH_BLOCK=128`` on the JAX side). f32 inputs agree
  within atol/rtol 1e-4 (only the order of f32 sums differs); bf16 inputs
  within atol/rtol 3e-2 (bf16 rounding of O, dq, dk, dv at one ulp of
  values up to ~4, and of the scaled q, P and dS, at places that differ
  between the frameworks; the JAX tests' own bf16 xla-vs-splash gap is of
  this size).
- K2: ``flash_attention_plain`` against ``xla_attention`` at f32.
  ``flash_attention_tpu`` has no interpret mode: its Pallas kernel runs on
  a TPU only, so the reference here is the function it computes.
- A 1-layer Llama through splash in both packages, weights carried across
  by ``convert.py``.
- The dispatcher's decision table.

Inputs are made from a seed with numpy and handed to both packages.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import llama as jl
from torchft_tpu.ops.attention import splash_attention_tpu, xla_attention
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.ops import attention as ta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the timing-sensitive tests of parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-4, "bfloat16": 3e-2}
HEADS = [(4, 4), (4, 2), (8, 2)]
S, HD = 256, 128


def _inputs(hq, hkv, batch=1, seed=0):
    rng = np.random.RandomState(seed + 10 * hq + hkv)
    return [rng.randn(batch, S, h, HD).astype(np.float32) for h in (hq, hkv, hkv)]


def _jax_value_and_grads(fn, arrays, dtype_name):
    dt = getattr(jnp, dtype_name)
    args = [jnp.asarray(a).astype(dt) for a in arrays]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)

    out = fn(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_value_and_grads(fn, arrays, dtype_name):
    dt = getattr(torch, dtype_name)
    args = [torch.from_numpy(a).to(dt).requires_grad_() for a in arrays]
    out = fn(*args)
    (out.float() ** 2).sum().backward()
    return [x.detach().float().numpy() for x in (out, *(a.grad for a in args))]


def _assert_close(got, ref, tol):
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("block", [None, "128"], ids=["one_tile", "multi_tile"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_splash_plain_matches_jax_splash(monkeypatch, hq, hkv, dtype_name, block):
    monkeypatch.delenv("TORCHFT_TPU_SPLASH_BLOCK", raising=False)
    monkeypatch.delenv("TORCHFT_TPU_SPLASH_BLOCK_KV", raising=False)
    if block:
        monkeypatch.setenv("TORCHFT_TPU_SPLASH_BLOCK", block)
    arrays = _inputs(hq, hkv)
    ref = _jax_value_and_grads(
        lambda q, k, v: splash_attention_tpu(q, k, v, None, interpret=True), arrays, dtype_name
    )
    got = _torch_value_and_grads(ta.splash_attention_plain, arrays, dtype_name)
    _assert_close(got, ref, TOL[dtype_name])


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_flash_plain_matches_jax_xla_f32(hq, hkv):
    arrays = _inputs(hq, hkv, batch=2)
    ref = _jax_value_and_grads(lambda q, k, v: xla_attention(q, k, v, None), arrays, "float32")
    got = _torch_value_and_grads(ta.flash_attention_plain, arrays, "float32")
    _assert_close(got, ref, TOL["float32"])


def test_plain_backward_is_the_autograd_of_plain_forward():
    """The hand-written plain backward equals torch autograd through a
    softmax attention forward (f32, flash scale): the kernels' backward
    contract is the derivative of their forward. atol/rtol 1e-5: f32 sums
    in another order."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(4, 2, batch=1, seed=5))
    scale = HD ** -0.5

    def forward_ops(q, k, v):
        qf, kf, vf = q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(2, 1), v.transpose(1, 2).repeat_interleave(2, 1)
        s = (qf @ kf.transpose(-1, -2)) * scale
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
        return (torch.softmax(s, -1) @ vf).transpose(1, 2)

    do = torch.from_numpy(np.random.RandomState(6).randn(1, S, 4, HD).astype(np.float32))
    ref = torch.autograd.grad(forward_ops(q, k, v), (q, k, v), do)
    q, k, v = q.detach(), k.detach(), v.detach()
    o, lse = ta.attention_fwd_plain(q, k, v, scale, p_f32=True)
    delta = ta.attention_delta(o, do)
    dq = ta.attention_dq_plain(q, k, v, lse, delta, do, scale)
    dk, dv = ta.attention_dkv_plain(q, k, v, lse, delta, do, scale)
    for got, want in zip((dq, dk, dv), ref):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_llama_layer_through_splash_matches_jax():
    jcfg = dataclasses.replace(
        jl.CONFIGS["tiny"], dim=512, n_layers=1, n_heads=4, n_kv_heads=2, dtype=jnp.float32
    )
    tcfg = dataclasses.replace(
        tl.CONFIGS["tiny"], dim=512, n_layers=1, n_heads=4, n_kv_heads=2, dtype=torch.float32
    )
    params = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    model = tl.Llama(tcfg, device="cpu", attention="splash")
    model.load_state_dict(convert.llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, jcfg.vocab_size, (1, 128)).astype(np.int32)
    targets = rng.randint(0, jcfg.vocab_size, (1, 128)).astype(np.int32)

    def splash(q, k, v, cfg):
        return splash_attention_tpu(q, k, v, cfg, interpret=True)

    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jl.llama_loss(p, jnp.asarray(tokens), jnp.asarray(targets), jcfg, attention_fn=splash)
    )(params)
    loss = model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    loss.backward()
    assert ta.LAST_DISPATCH == "splash"
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4, atol=1e-4)
    grads = dict(model.named_parameters())
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(
            grads[name].grad.numpy(), np.asarray(ref_grads[name]), rtol=1e-3, atol=1e-6, err_msg=name
        )
    for name, stacked in ref_grads["layers"].items():
        np.testing.assert_allclose(
            grads[f"layers.0.{name}"].grad.numpy(), np.asarray(stacked[0]),
            rtol=1e-3, atol=1e-6, err_msg=name,
        )


# (impl, S, hd, Hq, Hkv, cuda, dtype) -> what the reference's rule runs
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
DISPATCH = [
    ("auto", 2048, 128, 16, 8, True, BF16, "splash"),
    ("auto", 2048, 128, 16, 16, True, BF16, "flash"),
    ("auto", 256, 64, 4, 1, True, BF16, "splash"),
    ("auto", 2048, 128, 16, 8, False, BF16, "xla"),
    ("auto", 2048, 96, 16, 8, True, BF16, "xla"),
    ("auto", 100, 128, 16, 8, True, BF16, "xla"),
    ("xla", 2048, 128, 16, 8, True, BF16, "xla"),
    ("splash", 2048, 128, 16, 16, True, BF16, "splash"),
    ("flash", 2048, 128, 16, 8, True, BF16, "flash"),
    ("splash", 16, 16, 4, 2, False, BF16, "splash"),
    ("flash", 16, 16, 4, 4, False, BF16, "flash"),
    ("splash", 16, 16, 4, 2, True, BF16, "xla"),
    # the kernels take bf16 only: any other dtype on the card at a shape
    # they tile raises rather than run the materialized path in their place
    ("auto", 2048, 128, 16, 8, True, F32, TypeError),
    ("auto", 2048, 128, 16, 16, True, F16, TypeError),
    ("splash", 2048, 128, 16, 8, True, F32, TypeError),
    ("splash", 256, 64, 4, 2, True, F16, TypeError),
    ("flash", 2048, 128, 16, 16, True, F32, TypeError),
    ("flash", 2048, 256, 16, 8, True, F16, TypeError),
    # ... while "xla" and the shapes they do not tile take any dtype
    ("xla", 2048, 128, 16, 8, True, F32, "xla"),
    ("splash", 2048, 96, 16, 8, True, F16, "xla"),
    # on the CPU an explicit choice runs its plain version in any dtype
    ("splash", 16, 16, 4, 2, False, F32, "splash"),
    ("flash", 16, 16, 4, 4, False, F16, "flash"),
    ("auto", 2048, 128, 16, 8, False, F32, "xla"),
]


@pytest.mark.parametrize("impl,seq,hd,hq,hkv,cuda,dtype,want", DISPATCH)
def test_dispatch_follows_the_reference_rule(impl, seq, hd, hq, hkv, cuda, dtype, want):
    if want is TypeError:
        with pytest.raises(TypeError, match="bf16"):
            ta.resolve_impl(impl, (1, seq, hq, hd), hkv, cuda, dtype)
    else:
        assert ta.resolve_impl(impl, (1, seq, hq, hd), hkv, cuda, dtype) == want


def test_tileable_cuda_never_resolves_to_xla():
    """bf16 at every tileable shape runs a kernel on the card."""
    for impl, seq, hd, (hq, hkv) in itertools.product(
        ("auto", "splash", "flash"), (128, 256, 2048, 8192), ta.KERNEL_HEAD_DIMS,
        ((16, 8), (16, 16), (32, 8), (4, 1)),
    ):
        assert ta.resolve_impl(impl, (2, seq, hq, hd), hkv, True, torch.bfloat16) != "xla"
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.resolve_impl("cudnn", (1, 128, 4, 64), 4, True, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_causal_attention_resolves_with_the_dtype_of_its_q(monkeypatch, dtype):
    """causal_attention hands resolve_impl the dtype of its own q (no
    argument carries it), so an f32/f16 model on the card is refused at
    dispatch, with the remedy named, instead of inside a kernel wrapper."""
    seen = []

    def record(impl, q_shape, kv_heads, cuda, dtype_):
        seen.append((impl, tuple(q_shape), kv_heads, cuda, dtype_))
        return "xla"

    monkeypatch.setattr(ta, "resolve_impl", record)
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, h, 16).astype(np.float32)).to(dtype)
               for h in (4, 2, 2))
    out = ta.causal_attention(q, k, v, impl="splash")
    assert seen == [("splash", (1, 16, 4, 16), 2, False, dtype)]
    assert ta.LAST_DISPATCH == "xla"
    assert out.dtype == dtype and out.shape == q.shape


def test_row_statistics_are_checked_and_made_kernel_ready():
    """The dq and dK/dV kernels read lse and delta as f32 [B, Hq, S] rows on
    q's device, contiguous and 16-byte aligned: anything else of the wrong
    dtype, shape or device raises, a strided or misaligned one is copied."""
    q = torch.zeros(2, 128, 4, 64, dtype=torch.bfloat16)
    good = torch.zeros(2, 4, 128)
    assert ta._stat(good, q) is good
    for bad in (good.double(), good.to(torch.bfloat16), good[:, :2], good.reshape(2, 128, 4),
                good.transpose(1, 2)):
        with pytest.raises(ValueError, match="row statistics"):
            ta._stat(bad, q)
    strided = torch.zeros(2, 4, 256)[:, :, ::2]
    fixed = ta._stat(strided, q)
    assert fixed.is_contiguous() and fixed.data_ptr() % 16 == 0 and torch.equal(fixed, strided)
    misaligned = torch.arange(2 * 4 * 128 + 1, dtype=torch.float32)[1:].view(2, 4, 128)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    fixed = ta._stat(misaligned, q)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, misaligned)
