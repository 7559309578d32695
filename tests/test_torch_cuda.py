"""The port's CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import pytest
import torch

from torchft_tpu_torch.ops import attention as ta
from torchft_tpu_torch.ops import quantization as tq


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 511, 512 * 256 + 7])
def test_cuda_kernels_match_plain(cuda_device, n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(cuda_device)
    x[::97] *= 1e6
    tq.reset_launches()
    qk, sk, nk = tq.fused_quantize_fp8(x)
    qp, sp, _ = tq.quantize_fp8_plain(x)
    assert torch.equal(qk.view(torch.uint8), qp.view(torch.uint8))
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))
    dk = tq.fused_dequantize_fp8(qk, sk, nk)
    assert torch.equal(dk.view(torch.int32), tq.dequantize_fp8_plain(qk, sk, nk).view(torch.int32))
    assert tq.LAUNCHES == {"quantize_fp8_rowwise": 1, "dequantize_fp8_rowwise": 1}


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(1024, device=cuda_device)
    with pytest.raises(ValueError, match="cannot hold"):
        tq.fused_quantize_fp8(x, rows=1)
    q, s, n = tq.fused_quantize_fp8(x)
    with pytest.raises(ValueError):
        tq.fused_dequantize_fp8(q.reshape(4, 256), s, n)
    with pytest.raises(ValueError):
        tq.fused_dequantize_fp8(q, s.cpu(), n)
    with pytest.raises(ValueError):
        tq.fused_dequantize_fp8(q, s, q.numel() + 1)


def _attention_inputs(device, hq, hkv, hd, seq=256, batch=2):
    g = torch.Generator().manual_seed(hq * 100 + hkv * 10 + hd)
    return [torch.randn(batch, seq, h, hd, generator=g).to(device, torch.bfloat16).requires_grad_()
            for h in (hq, hkv, hkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["splash", "flash"])
@pytest.mark.parametrize("hq,hkv,hd", [(4, 2, 64), (4, 4, 128), (8, 2, 128)])
def test_cuda_attention_kernels_match_plain(cuda_device, impl, hq, hkv, hd):
    """Kernel path against the plain path on the card, forward and the
    gradients of sum(out.float()**2). Tolerance 5e-2: both round O, P, dS
    and the gradients to bf16, at values up to ~8 (dq, dk), and may round
    one element to neighbouring bf16 values."""
    fn = {"splash": (ta.splash_attention, ta.splash_attention_plain),
          "flash": (ta.flash_attention, ta.flash_attention_plain)}[impl]
    results = []
    for f in fn:
        q, k, v = _attention_inputs(cuda_device, hq, hkv, hd)
        ta.reset_launches()
        out = f(q, k, v)
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        results.append((dict(ta.LAUNCHES), [out.detach(), q.grad, k.grad, v.grad]))
    (launched, got), (plain_launched, want) = results
    assert {k: n for k, n in launched.items() if n} == {f"{impl}_fwd": 1, f"{impl}_dq": 1, f"{impl}_dkv": 1}
    assert not any(plain_launched.values())
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=5e-2, atol=5e-2, msg=name)


@pytest.mark.cuda
def test_cuda_attention_rejects_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn(1, 128, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        ta.attention_fwd(q, q, q, 1.0, "flash")
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ta.attention_fwd(q[..., :48], q[..., :48], q[..., :48], 1.0, "flash")
    with pytest.raises(ValueError, match="seq_len"):
        ta.attention_fwd(q[:, :96], q[:, :96], q[:, :96], 1.0, "flash")
    # auto on a tileable CUDA shape runs the kernel, never the xla path
    ta.causal_attention(q, q, q)
    assert ta.LAST_DISPATCH == "flash"


@pytest.mark.cuda
def test_cuda_attention_build_failure_raises(cuda_device, monkeypatch, tmp_path):
    from torchft_tpu_torch.ops import _build

    (tmp_path / "attention.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    ta._kernels.cache_clear()
    try:
        q = torch.randn(1, 128, 2, 64, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ta.attention_fwd(q, q, q, 1.0, "flash")
    finally:
        ta._kernels.cache_clear()


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# (B, S, Hq, Hkv, hd, K/V as strided views of one fused [B, S, 2 Hkv, hd])
ERROR_RATIO_CASES = [
    (1, 128, 4, 2, 128, False),   # one tile
    (1, 384, 4, 2, 128, False),   # an odd number of 128-row tiles
    (2, 256, 4, 2, 128, False),
    (1, 256, 16, 8, 128, True),   # strided K/V views
    (2, 256, 4, 2, 64, False),
    (2, 256, 4, 4, 64, True),
    (2, 256, 4, 2, 256, False),
    (1, 384, 4, 1, 256, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["splash", "flash"])
@pytest.mark.parametrize("batch,seq,hq,hkv,hd,fused", ERROR_RATIO_CASES)
def test_cuda_attention_kernels_error_ratio(cuda_device, impl, batch, seq, hq, hkv, hd, fused):
    """Forward, dq and dk/dv kernels against an f32 evaluation of the same
    bf16 inputs: each output's max abs error is at most twice the plain
    bf16 version's (the two round at the same places), and lse is within
    1e-3."""
    g = torch.Generator().manual_seed(batch * 1000 + seq + hq * 10 + hd)
    q = torch.randn(batch, seq, hq, hd, generator=g).to(cuda_device, torch.bfloat16)
    if fused:
        kv = torch.randn(batch, seq, 2 * hkv, hd, generator=g).to(cuda_device, torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        assert not k.is_contiguous()
    else:
        k, v = (torch.randn(batch, seq, hkv, hd, generator=g).to(cuda_device, torch.bfloat16)
                for _ in range(2))
    if impl == "splash":
        q, sm = q * ta.splash_scale(hd, q.dtype), 1.0
    else:
        sm = hd ** -0.5
    f32 = [x.float() for x in (q, k, v)]
    o_p, lse_p = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    o_32, lse_32 = ta.attention_fwd_plain(*f32, sm, True)
    do = (2 * o_p.float()).to(torch.bfloat16)
    args = (q, k, v, lse_p, ta.attention_delta(o_p, do), do, sm)
    args_32 = (*f32, lse_32, ta.attention_delta(o_32, do.float()), do.float(), sm)
    ta.reset_launches()
    o_k, lse_k = ta.attention_fwd(q, k, v, sm, impl)
    dq_k = ta.attention_dq(*args, impl)
    dk_k, dv_k = ta.attention_dkv(*args, impl)
    torch.cuda.synchronize()
    assert {n: c for n, c in ta.LAUNCHES.items() if c} == {
        f"{impl}_fwd": 1, f"{impl}_dq": 1, f"{impl}_dkv": 1}
    assert _max_err(lse_k, lse_32) <= 1e-3
    dk_p, dv_p = ta.attention_dkv_plain(*args)
    dk_32, dv_32 = ta.attention_dkv_plain(*args_32)
    for name, got, plain, ref in (
        ("o", o_k, o_p, o_32),
        ("dq", dq_k, ta.attention_dq_plain(*args), ta.attention_dq_plain(*args_32)),
        ("dk", dk_k, dk_p, dk_32),
        ("dv", dv_k, dv_p, dv_32),
    ):
        assert got.shape == plain.shape and bool(torch.isfinite(got).all()), name
        assert _max_err(got, ref) <= 2 * _max_err(plain, ref), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("impl", ["auto", "splash", "flash"])
def test_cuda_non_bf16_attention_raises_at_dispatch(cuda_device, dtype, impl):
    """An f32/f16 model on the card at a shape the kernels tile is refused
    at dispatch: the kernels are bf16 only, and the materialized path does
    not stand in for them. impl="xla" still runs it, and equals
    xla_attention."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, 128, h, 64, generator=g).to(cuda_device, dtype) for h in (4, 2, 2))
    ta.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        ta.causal_attention(q, k, v, impl=impl)
    out = ta.causal_attention(q, k, v, impl="xla")
    assert ta.LAST_DISPATCH == "xla"
    assert not any(ta.LAUNCHES.values())
    torch.testing.assert_close(out, ta.xla_attention(q, k, v), rtol=0, atol=0)
