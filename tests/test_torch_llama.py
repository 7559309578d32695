"""The port's Llama against the JAX package's, on the CPU.

JAX ``llama_init`` parameters go through ``convert.llama_params_from_jax``
into the port's ``Llama``; the same numpy tokens go to both. At f32 the
logits, the loss (plain and ``loss_chunk``) and every gradient agree within
rtol 1e-4 / atol 1e-5: both compute the same function and differ only in
the order of f32 sums. At bf16 the loss agrees within rtol 2e-2, the
rounding of bf16 activations at different places in the two frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import llama as jl
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the timing-sensitive tests of parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-4, 1e-5


def _configs(dtype_name: str):
    base = jl.CONFIGS["tiny"]
    jcfg = dataclasses.replace(base, n_layers=2, dtype=getattr(jnp, dtype_name))
    tcfg = dataclasses.replace(tl.CONFIGS["tiny"], n_layers=2, dtype=getattr(torch, dtype_name))
    return jcfg, tcfg


def _models(dtype_name: str):
    jcfg, tcfg = _configs(dtype_name)
    params = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    model = tl.Llama(tcfg, device="cpu", attention="xla")
    model.load_state_dict(convert.llama_params_from_jax(host))
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    targets = rng.randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, params, model, tokens, targets


def test_logits_match_f32():
    jcfg, params, model, tokens, _ = _models("float32")
    ref = np.asarray(jl.llama_forward(params, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long()).numpy()
    assert tattn.LAST_DISPATCH == "xla"
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_grads_match_f32(loss_chunk):
    jcfg, params, model, tokens, targets = _models("float32")
    loss_fn = lambda p: jl.llama_loss(  # noqa: E731
        p, jnp.asarray(tokens), jnp.asarray(targets), jcfg, loss_chunk=loss_chunk
    )
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    loss = model.loss(
        torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(), loss_chunk
    )
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=RTOL, atol=ATOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(grads[name], np.asarray(ref_grads[name]), rtol=RTOL, atol=ATOL)
    for name, stacked in ref_grads["layers"].items():
        for i in range(jcfg.n_layers):
            np.testing.assert_allclose(
                grads[f"layers.{i}.{name}"], np.asarray(stacked[i]),
                rtol=RTOL, atol=ATOL, err_msg=f"layers.{i}.{name}",
            )


def test_loss_matches_bf16():
    jcfg, params, model, tokens, targets = _models("bfloat16")
    ref = float(jl.llama_loss(params, jnp.asarray(tokens), jnp.asarray(targets), jcfg))
    with torch.no_grad():
        loss = float(model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()))
    np.testing.assert_allclose(loss, ref, rtol=2e-2)


def test_remat_keeps_grads():
    _, _, model, tokens, targets = _models("float32")
    grads = []
    for remat in (False, True):
        model.remat = remat
        model.zero_grad()
        model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_fused_attention_is_not_a_silent_fallback(impl, monkeypatch):
    """An explicit fused impl runs that kernel's path (its plain version on
    CPU tensors, which launches nothing), never the materialized one, and
    LAST_DISPATCH says so."""

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the materialized path")

    monkeypatch.setattr(tattn, "xla_attention", no_fallback)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    tattn.reset_launches()
    out = tattn.causal_attention(q, k, k, impl=impl)
    assert tattn.LAST_DISPATCH == impl
    assert not any(tattn.LAUNCHES.values())
    plain = tattn.splash_attention_plain if impl == "splash" else tattn.flash_attention_plain
    assert torch.equal(out, plain(q, k, k))
