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
