"""The port's causal attention against the JAX package's, on the CPU.

- K1: ``splash_attention_plain`` (the plain version of the port's splash
  kernels, forward and backward) against ``splash_attention_tpu`` run in
  Pallas interpret mode, one query/key tile and several
  (``TORCHFT_TPU_SPLASH_BLOCK=128`` on the JAX side). f32 inputs agree
  within atol/rtol 1e-4 (only the order of f32 sums differs); bf16 inputs
  within atol/rtol 3e-2 (bf16 rounding of O, dq, dk, dv at one ulp of
  values up to ~4, and of the scaled q, P and dS, at places that differ
  between the frameworks; the JAX tests' own bf16 xla-vs-splash gap is of
  this size); f16 inputs within 4e-3 (the same roundings in a format with
  three more mantissa bits: an eighth of bf16's, rounded up).
- K2: ``flash_attention_plain`` against ``xla_attention`` at f32, and in
  f16 against ``xla_attention`` in f32 on the same f16-rounded inputs.
  ``flash_attention_tpu`` has no interpret mode: its Pallas kernel runs on
  a TPU only, so the reference here is the function it computes.
- The plain forward over key tiles (the kernels' online softmax) against
  the same references.
- A 1-layer Llama through splash in both packages, weights carried across
  by ``convert.py``.
- The dispatcher's decision table, and ``TORCHFT_TPU_ATTENTION`` read
  where no implementation is passed.

Inputs are made from a seed with numpy and handed to both packages.
"""

import dataclasses
import functools
import itertools
import types

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


TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 4e-3}
HEADS = [(4, 4), (4, 2), (8, 2)]
S, HD = 256, 128


def _inputs(hq, hkv, batch=1, seed=0, hd=HD):
    rng = np.random.RandomState(seed + 10 * hq + hkv)
    return [rng.randn(batch, S, h, hd).astype(np.float32) for h in (hq, hkv, hkv)]


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
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "float16"])
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


@pytest.mark.parametrize("hd", [64, 128, 256], ids=["hd64", "hd128", "hd256"])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_flash_plain_f16_matches_jax_xla(hq, hkv, hd):
    """K2's plain version in f16 against the materialized reference in f32
    on the same f16-rounded inputs, at every head dim the f16 kernels are
    built for. atol/rtol 1e-2: the plain version rounds P, dS and its
    outputs to f16 (2^-11 relative each), which the f32 reference does not;
    dq and dk, sums of 256 such products, show it most (~5e-3)."""
    arrays = [a.astype(np.float16).astype(np.float32) for a in _inputs(hq, hkv, batch=2, hd=hd)]
    ref = _jax_value_and_grads(lambda q, k, v: xla_attention(q, k, v, None), arrays, "float32")
    got = _torch_value_and_grads(ta.flash_attention_plain, arrays, "float16")
    _assert_close(got, ref, 1e-2)


@pytest.mark.parametrize("dtype_name", ["float32", "float16"])
@pytest.mark.parametrize("hd", [64, 256], ids=["hd64", "hd256"])
@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_tiled_plain_forward_matches_jax_xla(impl, hd, dtype_name):
    """The plain forward over the forward kernel's key tiles (an online
    softmax: P taken, and for flash rounded, at each tile's running max)
    against the materialized reference in f32 on the same (f16-rounded)
    inputs, output and lse. Tolerance: f32 1e-4 (sums in another order);
    f16 4e-3 (O rounded to f16 at values up to ~3, and flash's P rounded to
    f16, as in the splash f16 bar above)."""
    arrays = [a.astype(np.float16).astype(np.float32) for a in _inputs(4, 2, batch=2, hd=hd)]
    dtype = getattr(torch, dtype_name)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    sm = hd ** -0.5
    if impl == "splash":
        q, sm = q * ta.splash_scale(hd, dtype), 1.0
    o, lse = ta.attention_fwd_plain(q, k, v, sm, impl == "splash", ta.FWD_KEY_TILE[hd])
    o_u, lse_u = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    qj = np.asarray(q.float()) * (sm * hd ** 0.5)  # xla_attention divides by sqrt(hd)
    ref = np.asarray(xla_attention(jnp.asarray(qj), *(jnp.asarray(a) for a in arrays[1:]), None))
    np.testing.assert_allclose(o.float().numpy(), ref, rtol=TOL[dtype_name], atol=TOL[dtype_name])
    torch.testing.assert_close(lse, lse_u, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_u, rtol=1e-5, atol=1e-5)


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
BF16, F16, F32, F64 = torch.bfloat16, torch.float16, torch.float32, torch.float64
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
    # the rule has no dtype clause: f32 and f16 on the card at a shape the
    # kernels tile run a kernel too (attention_tf32x3.cu, attention.cu) ...
    ("auto", 2048, 128, 16, 8, True, F32, "splash"),
    ("auto", 2048, 128, 16, 16, True, F16, "flash"),
    ("splash", 2048, 128, 16, 8, True, F32, "splash"),
    ("splash", 256, 64, 4, 2, True, F16, "splash"),
    ("flash", 2048, 128, 16, 16, True, F32, "flash"),
    ("flash", 2048, 256, 16, 8, True, F16, "flash"),
    # ... a dtype no kernel takes raises rather than run the materialized
    # path in a kernel's place ...
    ("auto", 2048, 128, 16, 8, True, F64, TypeError),
    ("splash", 256, 64, 4, 2, True, F64, TypeError),
    ("flash", 2048, 128, 16, 16, True, F64, TypeError),
    # ... while "xla" and the shapes they do not tile take any dtype
    ("xla", 2048, 128, 16, 8, True, F32, "xla"),
    ("splash", 2048, 96, 16, 8, True, F16, "xla"),
    ("auto", 100, 128, 16, 8, True, F64, "xla"),
    # on the CPU an explicit choice runs its plain version in any dtype
    ("splash", 16, 16, 4, 2, False, F32, "splash"),
    ("flash", 16, 16, 4, 4, False, F16, "flash"),
    ("auto", 2048, 128, 16, 8, False, F32, "xla"),
]


@pytest.mark.parametrize("impl,seq,hd,hq,hkv,cuda,dtype,want", DISPATCH)
def test_dispatch_follows_the_reference_rule(impl, seq, hd, hq, hkv, cuda, dtype, want):
    if want is TypeError:
        with pytest.raises(TypeError, match="kernels take bfloat16, float16, float32"):
            ta.resolve_impl(impl, (1, seq, hq, hd), hkv, cuda, dtype)
    else:
        assert ta.resolve_impl(impl, (1, seq, hq, hd), hkv, cuda, dtype) == want


def test_tileable_cuda_never_resolves_to_xla():
    """Every dtype the kernels take, at every tileable shape, runs a kernel
    on the card."""
    assert set(ta.KERNEL_DTYPES) == {torch.bfloat16, torch.float16, torch.float32}
    for impl, seq, hd, (hq, hkv), dtype in itertools.product(
        ("auto", "splash", "flash"), (128, 256, 2048, 8192), ta.KERNEL_HEAD_DIMS,
        ((16, 8), (16, 16), (32, 8), (4, 1)), ta.KERNEL_DTYPES,
    ):
        assert ta.resolve_impl(impl, (2, seq, hq, hd), hkv, True, dtype) != "xla"
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.resolve_impl("cudnn", (1, 128, 4, 64), 4, True, torch.bfloat16)


# TORCHFT_TPU_ATTENTION (None: unset), S, Hq, Hkv, on the card -> what a
# call that passes no implementation resolves to
ENV_DISPATCH = [
    (None, 2048, 16, 8, True, "splash"),
    (None, 2048, 16, 16, True, "flash"),
    ("auto", 2048, 16, 8, True, "splash"),
    ("auto", 2048, 16, 16, True, "flash"),
    ("xla", 2048, 16, 8, True, "xla"),
    ("flash", 2048, 16, 8, True, "flash"),
    ("splash", 2048, 16, 16, True, "splash"),
    ("splash", 100, 16, 8, True, "xla"),
    # off the card every value resolves to xla, as in the reference
    *[(value, 2048, 16, 8, False, "xla") for value in (None, "auto", "xla", "splash", "flash")],
]


@pytest.mark.parametrize("value,seq,hq,hkv,cuda,want", ENV_DISPATCH)
def test_no_impl_reads_the_variable(monkeypatch, value, seq, hq, hkv, cuda, want):
    if value is None:
        monkeypatch.delenv(ta.ATTENTION_ENV, raising=False)
    else:
        monkeypatch.setenv(ta.ATTENTION_ENV, value)
    assert ta.ATTENTION_ENV == "TORCHFT_TPU_ATTENTION"
    assert ta.resolve_impl(None, (1, seq, hq, 128), hkv, cuda, torch.bfloat16) == want


@pytest.mark.parametrize("value", ["auto", "xla", "splash", "flash", "cudnn"])
def test_an_explicit_impl_beats_the_variable(monkeypatch, value):
    monkeypatch.setenv(ta.ATTENTION_ENV, value)
    for impl, hkv, cuda, want in (("splash", 16, True, "splash"), ("flash", 8, True, "flash"),
                                  ("xla", 8, True, "xla"), ("auto", 8, True, "splash"),
                                  ("splash", 8, False, "splash")):
        assert ta.resolve_impl(impl, (1, 2048, 16, 128), hkv, cuda, torch.bfloat16) == want


@pytest.mark.parametrize("value", [None, "auto", "xla", "splash", "flash"])
def test_causal_attention_reads_the_variable_on_each_call(monkeypatch, value):
    """On CPU tensors a call with no implementation runs the materialized
    path for every value of the variable; an explicit "splash" still runs
    the plain splash version."""
    if value is None:
        monkeypatch.delenv(ta.ATTENTION_ENV, raising=False)
    else:
        monkeypatch.setenv(ta.ATTENTION_ENV, value)
    q, k, v = (torch.from_numpy(a[:, :128, :, :16].copy()) for a in _inputs(4, 2))
    out = ta.causal_attention(q, k, v)
    assert ta.LAST_DISPATCH == "xla"
    assert torch.equal(out, ta.xla_attention(q, k, v))
    ta.causal_attention(q, k, v, impl="splash")
    assert ta.LAST_DISPATCH == "splash"


def test_an_unknown_value_of_the_variable_raises(monkeypatch):
    """The reference runs flash for a value it does not know; the port
    names the variable, on the card and off it."""
    monkeypatch.setenv(ta.ATTENTION_ENV, "cudnn")
    with pytest.raises(ValueError, match="unknown TORCHFT_TPU_ATTENTION value 'cudnn'"):
        ta.resolve_impl(None, (1, 2048, 16, 128), 8, True, torch.bfloat16)
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="TORCHFT_TPU_ATTENTION"):
        ta.causal_attention(q, q, q)


def test_llama_default_attention_reaches_causal_attention_as_none(monkeypatch):
    """Llama and its layers default to attention=None and pass it on, so
    the variable decides; the trainer builds its model that way."""
    from torchft_tpu_torch import train

    seen = []

    def record(q, k, v, cfg, impl):
        seen.append(impl)
        return ta.causal_attention(q, k, v, cfg, impl=impl)

    monkeypatch.setattr(tl, "causal_attention", record)
    monkeypatch.setenv(ta.ATTENTION_ENV, "xla")
    cfg = dataclasses.replace(tl.CONFIGS["tiny"], n_layers=2, dtype=torch.float32)
    model = tl.Llama(cfg, device="cpu")
    assert [layer.attention for layer in model.layers] == [None, None]
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(4).randint(0, cfg.vocab_size, (1, 17)))
    model.loss(tokens[:, :-1], tokens[:, 1:])
    assert seen == [None, None] and ta.LAST_DISPATCH == "xla"
    trainer_model, _, _ = train.build_trainer(
        train.TrainConfig(config="debug", seq_len=16), 0, torch.device("cpu"))
    assert {layer.attention for layer in trainer_model.layers} == {None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_causal_attention_resolves_with_the_dtype_of_its_q(monkeypatch, dtype):
    """causal_attention hands resolve_impl the dtype of its own q (no
    argument carries it), so a model in a dtype no kernel takes is refused
    at dispatch, with the remedy named, instead of inside a kernel
    wrapper."""
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


def test_launches_are_counted_per_dtype_family():
    """bf16 launches count under the path's own keys, the f32/f16 kernels'
    under keys ending in _f32/_f16, so a run shows which family ran."""
    want = {f"{impl}_{kernel}{suffix}" for impl in ("splash", "flash")
            for kernel in ("fwd", "dq", "dkv") for suffix in ("", "_f32", "_f16")}
    assert set(ta.LAUNCHES) == want
    assert ta._launch_name("splash", "dq", torch.bfloat16) == "splash_dq"
    assert ta._launch_name("flash", "dkv", torch.float32) == "flash_dkv_f32"
    assert ta._launch_name("splash", "fwd", torch.float16) == "splash_fwd_f16"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_cpu_wrappers_run_the_plain_versions_in_every_dtype(impl, dtype):
    """On CPU tensors the three wrappers return their plain versions'
    results in the input dtype, and launch nothing."""
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 128, h, 64).astype(np.float32)).to(dtype)
                   for h in (4, 2, 2, 4))
    sm = 1.0 if impl == "splash" else 64 ** -0.5
    ta.reset_launches()
    o, lse = ta.attention_fwd(q, k, v, sm, impl)
    o_p, lse_p = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    delta = ta.attention_delta(o, do)
    dq = ta.attention_dq(q, k, v, lse, delta, do, sm, impl)
    dk, dv = ta.attention_dkv(q, k, v, lse, delta, do, sm, impl)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert torch.equal(dq, ta.attention_dq_plain(q, k, v, lse, delta, do, sm))
    assert not any(ta.LAUNCHES.values())


# (kernel, dtype) -> (source, dtype code its entry point takes first): the
# tensor-core kernels of attention.cu run bf16 and f16, the 3xTF32
# tensor-core kernels of attention_tf32x3.cu f32
WANT_ROUTES = {
    ("fwd", BF16): ("attention.cu", 0), ("dq", BF16): ("attention.cu", 0),
    ("dkv", BF16): ("attention.cu", 0),
    ("fwd", F16): ("attention.cu", 1), ("dq", F16): ("attention.cu", 1),
    ("dkv", F16): ("attention.cu", 1),
    ("fwd", F32): ("attention_tf32x3.cu", 0), ("dq", F32): ("attention_tf32x3.cu", 0),
    ("dkv", F32): ("attention_tf32x3.cu", 0),
}
# the C entry-point prefix of each source
PREFIXES = {"attention.cu": "tft_attention", "attention_tf32x3.cu": "tft_tf32x3_attention"}


@pytest.mark.parametrize("kernel,dtype", list(WANT_ROUTES), ids=lambda x: str(x).replace("torch.", ""))
def test_each_kernel_and_dtype_calls_its_sources_entry_point(monkeypatch, kernel, dtype):
    """_entry resolves (kernel, dtype) to the C entry point of its source
    with its dtype code bound first; stub libraries stand in for the built
    ones, so nothing is compiled."""
    def library(source):
        return types.SimpleNamespace(**{
            f"{PREFIXES[source]}_{k}": functools.partial(lambda k, *args: (source, k, args), k)
            for k in ("fwd", "dq", "dkv")})

    monkeypatch.setattr(ta, "_library", library)
    source, code = WANT_ROUTES[(kernel, dtype)]
    assert ta.ROUTES[(kernel, dtype)] == (source, code)
    got = ta._entry(kernel, dtype)("q", "k")
    assert got == (source, kernel, (code, "q", "k"))


def test_every_kernel_dtype_has_one_route():
    assert set(ta.ROUTES) == {(k, d) for k in ("fwd", "dq", "dkv") for d in ta.KERNEL_DTYPES}


def _tensor_with_seq_stride(dtype, pad):
    """[1, 128, 2, 64] whose sequence stride is 128 + pad elements."""
    return torch.zeros(1, 128, 128 + pad, dtype=dtype)[:, :, :128].unflatten(2, (2, 64))


def _tensor_at_element(dtype, shift):
    """A contiguous [1, 128, 2, 64] whose base lies `shift` elements past a
    16-byte aligned one."""
    return torch.zeros(1 * 128 * 2 * 64 + 8, dtype=dtype)[shift:shift + 128 * 2 * 64].view(1, 128, 2, 64)


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_tma_rule_holds_for_the_dtypes_attention_cu_reads(dtype):
    """Every kernel reads by TMA (attention.cu in bf16 and f16,
    attention_tf32x3.cu in f32, the forward included), so every wrapper's
    check asks for a 16-byte aligned base and batch/sequence/head strides of
    whole 16 bytes, and refuses anything else."""
    per16 = 16 // torch.tensor([], dtype=dtype).element_size()
    fine = _tensor_with_seq_stride(dtype, per16)
    odd = _tensor_with_seq_stride(dtype, per16 // 2)
    shifted = _tensor_at_element(dtype, 1)
    assert odd.stride()[1] % per16 and shifted.data_ptr() % 16
    for kernel in ("fwd", "dq", "dkv"):
        ta._check_inputs(kernel, fine, fine, fine)
        for x in (odd, shifted):
            with pytest.raises(ValueError, match="16-byte aligned base and strides"):
                ta._check_inputs(kernel, x, x, x)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_alignment_rule_is_counted_in_bytes_by_route(kernel):
    """TMA's rule is in bytes: an f32 sequence stride of 132 elements (528
    bytes, 33 x 16) is whole 16 bytes and passes, one of 130 (520 bytes)
    does not, nor does a base 8 bytes (2 f32 elements) past a 16-byte
    boundary; the error names the kernel, its source and the rule."""
    ta._check_inputs(kernel, *[_tensor_with_seq_stride(F32, 4)] * 3)
    for x in (_tensor_with_seq_stride(F32, 2), _tensor_at_element(F32, 2)):
        with pytest.raises(ValueError, match=rf"float32 attention {kernel} kernel "
                           r"\(attention_tf32x3.cu\) reads by TMA.*\(4 elements\)"):
            ta._check_inputs(kernel, x, x, x)
    # bf16 counts the same 16 bytes as 8 elements
    ta._check_inputs(kernel, *[_tensor_with_seq_stride(BF16, 8)] * 3)
    with pytest.raises(ValueError, match=r"\(8 elements\)"):
        ta._check_inputs(kernel, *[_tensor_with_seq_stride(BF16, 4)] * 3)


# ---------------------------------------------------------------------------
# A CPU model of attention_tf32x3.cu's arithmetic (3xTF32), in f64: the
# forward and the backward
# ---------------------------------------------------------------------------
# bits wgmma's f32 sums keep, aligned to the largest addend and truncated:
# the low end of what PERF.md's fit to the card (PR 6) found, ~22-23
TC_BITS = 22


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x's top 19 bits: how the tensor core reads an f32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32, ties away from zero (the kernel's rna_tf32)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_register(x):
    """A register operand: hi = rna(x), lo = rna(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _split_shared(x):
    """A shared-memory operand read raw: the tensor core truncates it to
    its hi; the kernel writes lo = rna(x - hi) beside it."""
    hi = _tf32_trunc(x)
    return hi, _tf32_rna(x - hi)


def _tc_step(acc, a, b):
    """One k8 step on the tensor core: acc + a [..., M, 8] @ b [..., 8, N]
    exactly, then cut to TC_BITS bits of its largest addend (toward zero)
    and to f32. acc and the result are f64 holding f32 values."""
    prods = a.double().unsqueeze(-1) * b.double().unsqueeze(-3)
    total = acc + prods.sum(-2)
    big = torch.maximum(acc.abs(), prods.abs().amax(-2))
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(big > 0, big, torch.ones_like(big))))
                         - (TC_BITS - 1))
    return (torch.trunc(total / quantum) * quantum).float().double()


def _product_3x(a, b):
    """a [..., M, K] @ b [..., K, N] as product_3x: a split as a register
    operand, b as a shared one; per 16 of K the small products (lo*hi,
    hi*lo) in one fresh accumulator and the hi*hi ones in another, both
    added to the running sum in f32, hi*hi first."""
    ah, al = _split_register(a)
    bh, bl = _split_shared(b)
    run = None
    for c in range(0, a.shape[-1], 16):
        small = part = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
        for k in (c, c + 8):
            small = _tc_step(small, al[..., k:k + 8], bh[..., k:k + 8, :])
            small = _tc_step(small, ah[..., k:k + 8], bl[..., k:k + 8, :])
        for k in (c, c + 8):
            part = _tc_step(part, ah[..., k:k + 8], bh[..., k:k + 8, :])
        run = (part.float() if run is None else run + part.float()) + small.float()
    return run


def _accumulate_3x(run, a, b, group):
    """run + a [..., M, K] @ b [..., K, N] as product_t3x computes its
    transpose: a (the accumulator written to shared memory) split as a
    register operand, b (the streamed tile) as a shared one; the products
    over each `group` of K in one fresh accumulator, smallest first (lo*hi,
    hi*lo, then hi*hi, each over the group), added to run in f32. With
    `group` None, run itself is the accumulator the products go into."""
    ah, al = _split_register(a)
    bh, bl = _split_shared(b)
    if group is None:
        d = run.double()
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            for k in range(0, a.shape[-1], 8):
                d = _tc_step(d, x[..., k:k + 8], y[..., k:k + 8, :])
        return d.float()
    for k0 in range(0, a.shape[-1], group):
        d = torch.zeros(run.shape, dtype=torch.float64)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            for k in range(k0, k0 + group, 8):
                d = _tc_step(d, x[..., k:k + 8], y[..., k:k + 8, :])
        run = run + d.float()
    return run


def _tf32x3_backward(q, k, v, lse, delta, do, sm, tile=32):
    """(dq, dk, dv) as attention_tf32x3.cu computes them at head dims
    64/128 (32-key and 32-query tiles): dq's S and dP with Q and dO as the
    register operands, dQ over each whole key tile, and its two consumers'
    partial sums (even and odd key tiles) added at the end; dK/dV's S^T and
    dP^T with K and V as the register operands, dS^T from P^T as the dV
    warpgroup hands it over (hi + lo of its split), dK and dV over 16
    queries at a time, summed over the group's heads (outer) and query
    tiles (inner)."""
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qf, dof = q.transpose(1, 2), do.transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(group, 1) for x in (k, v))
    causal = torch.ones(S, S, dtype=torch.bool).tril()

    def probs_and_ds(s, dp, lse_, delta_, mask):
        p = torch.exp((s * sm).masked_fill(~mask, ta.MASK_VALUE) - lse_)
        return p, (dp - delta_) * p * sm

    # dq: rows are queries
    _, ds = probs_and_ds(_product_3x(qf, kf.transpose(-1, -2)),
                         _product_3x(dof, vf.transpose(-1, -2)), lse[..., None], delta[..., None],
                         causal)
    partial = [torch.zeros(B, hq, S, D), torch.zeros(B, hq, S, D)]
    for i, k0 in enumerate(range(0, S, tile)):
        partial[i % 2] = _accumulate_3x(partial[i % 2], ds[..., k0:k0 + tile],
                                        kf[..., k0:k0 + tile, :], tile)
    dq = partial[0] + partial[1]
    # dK/dV: rows are keys; the dK warpgroup takes P^T as hi + lo
    pt, _ = probs_and_ds(_product_3x(kf, qf.transpose(-1, -2)), 0.0, lse[..., None, :], 0.0,
                         causal.T)
    pt_hi, pt_lo = _split_register(pt)
    dst = (_product_3x(vf, dof.transpose(-1, -2)) - delta[..., None, :]) * (pt_hi + pt_lo) * sm
    dk, dv = torch.zeros(B, hkv, S, D), torch.zeros(B, hkv, S, D)
    heads = [torch.arange(hkv) * group + j for j in range(group)]
    for h in heads:
        for q0 in range(0, S, tile):
            dv = _accumulate_3x(dv, pt[:, h, :, q0:q0 + tile], dof[:, h, q0:q0 + tile], 16)
            dk = _accumulate_3x(dk, dst[:, h, :, q0:q0 + tile], qf[:, h, q0:q0 + tile], 16)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _tf32x3_forward(q, k, v, sm, p_f32, tile=32, group=16):
    """(o, lse) as attention_tf32x3.cu's forward computes them at head dims
    64/128 (32-key tiles): S with Q as the register operand, scaled and
    masked; per row an online softmax over the key tiles in order (running
    max m, alpha = exp(m_old - m_new), l = l alpha + the tile's P summed in
    f32) and O, rescaled by alpha before the tile's P V is added (P split as
    a register operand, V as a shared one, the products over each ``group``
    keys in a fresh accumulator); o = O / l, lse = m + log l. A tile past a
    row's diagonal adds exactly 0 (P = exp(mask - m) = 0, alpha = 1), so
    every row takes every tile here, where the kernel's consumer of a
    block's first 64 rows skips the tiles past them. P rounded to the input
    dtype unless ``p_f32``: a no-op in f32. With ``group`` None, one
    accumulator holds a row of O for the whole row (rescaled in place, never
    emptied) instead."""
    B, S, hq, D = q.shape
    qf = q.transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(hq // k.shape[2], 1) for x in (k, v))
    s = _product_3x(qf, kf.transpose(-1, -2)) * sm
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), ta.MASK_VALUE)
    m = torch.full((B, hq, S, 1), ta.MASK_VALUE)
    l, run = torch.zeros(B, hq, S, 1), torch.zeros(B, hq, S, D)
    for k0 in range(0, S, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        run = _accumulate_3x(run * alpha, p if p_f32 else ta._round(p, q.dtype),
                             vf[..., k0:k0 + tile, :], group)
        m = m_new
    return (run * (1.0 / l)).transpose(1, 2), (m + torch.log(l))[..., 0]


def _attention_f64(q, k, v, sm, do=None):
    """(o, lse, (dq, dk, dv) if ``do`` is given) in f64, by autograd
    through a causal softmax attention."""
    group = q.shape[2] // k.shape[2]
    leaves = [x.detach().double().requires_grad_() for x in (q, k, v)]
    qf = leaves[0].transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(group, 1) for x in leaves[1:])
    s = (qf @ kf.transpose(-1, -2)) * sm
    s = s.masked_fill(~torch.ones(s.shape[-1], s.shape[-1], dtype=torch.bool).tril(), float("-inf"))
    o = (torch.softmax(s, -1) @ vf).transpose(1, 2)
    grads = None if do is None else torch.autograd.grad(o, leaves, do.double())
    return o.detach(), torch.logsumexp(s, -1).detach(), grads


def _f32_case(hd, hq, hkv, impl, seq=S):
    """(q, k, v, sm_scale) from a seed: q pre-scaled for splash."""
    rng = np.random.RandomState(hd + 10 * hq + hkv)
    q, k, v = (torch.from_numpy(rng.randn(1, seq, h, hd).astype(np.float32)) for h in (hq, hkv, hkv))
    if impl == "splash":
        return q * ta.splash_scale(hd, torch.float32), k, v, 1.0
    return q, k, v, hd ** -0.5


def _max_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


@pytest.mark.parametrize("impl", ["splash", "flash"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("hd", [64, 128])
def test_tf32x3_model_keeps_the_f32_bar(hd, hq, hkv, impl):
    """The split (register operands rounded, shared ones truncated by the
    tensor core with a rounded lo beside them) and the order of sums that
    attention_tf32x3.cu uses, modelled in f64 with wgmma's sums cut to
    TC_BITS bits, keep dq, dk and dv within the card's bar: 4x the plain
    f32 version's max abs error against f64 (S 256). The model first
    showed that one accumulator per product does not."""
    q, k, v, sm = _f32_case(hd, hq, hkv, impl)
    o, lse = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    do = 2 * o
    args = (q, k, v, lse, ta.attention_delta(o, do), do, sm)
    plain = (ta.attention_dq_plain(*args), *ta.attention_dkv_plain(*args))
    ref = _attention_f64(q, k, v, sm, do)[2]
    for name, got, want, r in zip(("dq", "dk", "dv"), _tf32x3_backward(*args), plain, ref):
        e_model, e_plain = _max_err(got, r), _max_err(want, r)
        assert e_model <= 4 * e_plain, (name, e_model, e_plain)


@pytest.mark.parametrize("impl", ["splash", "flash"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("hd", [64, 128])
def test_tf32x3_forward_model_keeps_the_f32_bar(hd, hq, hkv, impl):
    """The forward's arithmetic as attention_tf32x3.cu runs it (the
    split, the per-tile online softmax, O rescaled before each tile's sum,
    P V over each 16 keys in a fresh accumulator), modelled with wgmma's
    sums cut to TC_BITS bits, keeps o within the card's bar, 4x the plain
    f32 version's max abs error against f64 (S 256), and lse within
    1e-3."""
    q, k, v, sm = _f32_case(hd, hq, hkv, impl)
    o_p, _ = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    o_r, lse_r, _ = _attention_f64(q, k, v, sm)
    o_m, lse_m = _tf32x3_forward(q, k, v, sm, impl == "splash")
    assert o_m.shape == o_p.shape and lse_m.shape == lse_r.shape
    e_model, e_plain = _max_err(o_m, o_r), _max_err(o_p, o_r)
    assert e_model <= 4 * e_plain, (e_model, e_plain)
    assert _max_err(lse_m, lse_r) <= 1e-3


def test_tf32x3_forward_model_with_one_accumulator_a_row_fails_the_bar():
    """Why P V goes into fresh accumulators: with one accumulator for the
    whole of a row of O (rescaled in place), wgmma's truncated sums pile up
    over the row's key tiles. At S 512 (up to 16 key tiles a row) o
    leaves the 4x bar, which the fresh accumulators keep."""
    q, k, v, sm = _f32_case(64, 2, 1, "flash", seq=512)
    o_p, _ = ta.attention_fwd_plain(q, k, v, sm, False)
    o_r, _, _ = _attention_f64(q, k, v, sm)
    e_plain = _max_err(o_p, o_r)
    assert _max_err(_tf32x3_forward(q, k, v, sm, False)[0], o_r) <= 4 * e_plain
    e_one = _max_err(_tf32x3_forward(q, k, v, sm, False, group=None)[0], o_r)
    assert e_one > 4 * e_plain, (e_one, e_plain)
