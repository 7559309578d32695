"""The port's CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import pytest
import torch

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
