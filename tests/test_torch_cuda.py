"""The port's CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import re

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
    assert tq.LAUNCHES == {"quantize_fp8_rowwise": 1, "dequantize_fp8_rowwise": 1,
                           "quantize_fp8_rowwise_host": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 511, 512 * 256 + 7, 512 * 64])
def test_cuda_host_rule_kernel_matches_plain(cuda_device, n):
    """The host-rule quantize kernel against its plain version and the
    numpy host codec, bit for bit, with a zero row, an overflow row and a
    non-finite row; its launch is counted under its own key."""
    x = torch.randn(n, generator=torch.Generator().manual_seed(n))
    x[::97] *= 1e6
    if n >= 4 * 512:
        x[:512] = 0.0
        x[512 + 3] = 3e38
        x[1024 + 5] = float("nan")
        x[1536 + 7] = float("inf")
    tq.reset_launches()
    qk, sk, nk = tq.fused_quantize_fp8_host(x.to(cuda_device))
    qp, sp, _ = tq.quantize_fp8_host_plain(x)
    qh, sh, _ = tq.quantize_fp8_rowwise(x.numpy())
    assert torch.equal(qk.view(torch.uint8).cpu(), qp.view(torch.uint8))
    assert torch.equal(sk.view(torch.int32).cpu(), sp.view(torch.int32))
    assert (qk.view(torch.uint8).cpu().numpy() == qh).all()
    assert (sk.cpu().numpy().reshape(-1).view("u4") == sh.view("u4")).all()
    assert tq.LAUNCHES == {"quantize_fp8_rowwise": 0, "dequantize_fp8_rowwise": 0,
                           "quantize_fp8_rowwise_host": 1}


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
    with pytest.raises(TypeError, match="kernels take"):
        ta.attention_fwd(q.double(), q.double(), q.double(), 1.0, "flash")
    with pytest.raises(TypeError, match="share one dtype"):
        ta.attention_fwd(q, q.half(), q, 1.0, "flash")
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ta.attention_fwd(q[..., :48], q[..., :48], q[..., :48], 1.0, "flash")
    with pytest.raises(ValueError, match="seq_len"):
        ta.attention_fwd(q[:, :96], q[:, :96], q[:, :96], 1.0, "flash")
    # f16 tensors are read by TMA: one whose sequence stride (132 elements)
    # is not whole 16 bytes is refused
    h = torch.randn(1, 128, 132, device=cuda_device, dtype=torch.float16)[:, :, :128].unflatten(2, (2, 64))
    ta.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned base and strides"):
        ta.attention_fwd(h, h, h, 1.0, "flash")
    assert not any(ta.LAUNCHES.values())
    # auto on a tileable CUDA shape runs the kernel, never the xla path
    ta.causal_attention(q, q, q)
    assert ta.LAST_DISPATCH == "flash"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_attention_build_failure_raises(cuda_device, monkeypatch, tmp_path, dtype):
    """A broken attention.cu fails a bf16 or f16 forward with nvcc's output;
    no other kernel runs in its place."""
    from torchft_tpu_torch.ops import _build

    (tmp_path / "attention.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    ta._library.cache_clear()
    try:
        q = torch.randn(1, 128, 2, 64, device=cuda_device, dtype=dtype)
        ta.reset_launches()
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ta.attention_fwd(q, q, q, 1.0, "splash")
        assert not any(ta.LAUNCHES.values())
    finally:
        ta._library.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_cuda_tf32x3_attention_build_failure_raises(cuda_device, monkeypatch, tmp_path, kernel):
    """A broken attention_tf32x3.cu fails an f32 forward (through
    causal_attention), dq or dK/dV call with nvcc's output; no other kernel
    and not the plain version runs in its place."""
    from torchft_tpu_torch.ops import _build

    (tmp_path / "attention_tf32x3.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    ta._library.cache_clear()
    try:
        q = torch.randn(1, 128, 2, 64, device=cuda_device)
        stat = torch.zeros(1, 2, 128, device=cuda_device)
        calls = {"fwd": lambda: ta.causal_attention(q, q, q, impl="flash"),
                 "dq": lambda: ta.attention_dq(q, q, q, stat, stat, q, 1.0, "flash"),
                 "dkv": lambda: ta.attention_dkv(q, q, q, stat, stat, q, 1.0, "flash")}
        ta.reset_launches()
        with pytest.raises(RuntimeError, match="nvcc failed"):
            calls[kernel]()
        assert not any(ta.LAUNCHES.values())
    finally:
        ta._library.cache_clear()


@pytest.mark.cuda
def test_cuda_tf32_operands_are_read_truncated(cuda_device):
    """attention_tf32x3.cu takes a raw f32 tile as its own hi because the
    tensor core reads an f32 operand of a .tf32 wgmma as its top 19 bits,
    from registers (A) and shared memory (B) alike: the probe's products by
    1 equal x with its low 13 mantissa bits cleared, not x rounded."""
    import ctypes

    lib = ta._library("attention_tf32x3.cu")
    lib.tft_tf32x3_probe.argtypes = [ctypes.c_void_p] * 3
    g = torch.Generator().manual_seed(5)
    x = torch.randn(72, generator=g) * torch.exp2(torch.randint(-20, 20, (72,), generator=g).float())
    x[0] = x[64] = 1 + 2 ** -11 + 2 ** -13  # rounds up, truncates down
    x = x.to(cuda_device)
    out = torch.zeros_like(x)
    assert lib.tft_tf32x3_probe(x.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    truncated = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert torch.equal(out, truncated)
    assert not torch.equal(out, x)


@pytest.mark.cuda
def test_cuda_f32_alignment_is_checked_by_route(cuda_device):
    """An f32 tensor whose base is 4 bytes past a 16-byte boundary is
    refused by the forward, dq and dK/dV kernels alike (all read by TMA)
    with a ValueError naming the rule before any tile map is made; the
    same values copied to an aligned tensor run."""
    flat = torch.randn(1 * 128 * 2 * 64 + 4, device=cuda_device)
    x = flat[1:1 + 128 * 2 * 64].view(1, 128, 2, 64)
    assert x.data_ptr() % 16 == 4
    ta.reset_launches()
    o, lse = ta.attention_fwd(x.clone(), x.clone(), x.clone(), 1.0, "flash")
    torch.cuda.synchronize()
    assert ta.LAUNCHES["flash_fwd_f32"] == 1 and bool(torch.isfinite(o).all())
    delta = ta.attention_delta(o, x)
    with pytest.raises(ValueError, match=r"reads by TMA.*16-byte aligned base and strides"):
        ta.attention_fwd(x, x, x, 1.0, "flash")
    for fn in (ta.attention_dq, ta.attention_dkv):
        with pytest.raises(ValueError, match=r"reads by TMA.*16-byte aligned base and strides"):
            fn(x, x, x, lse, delta, x, 1.0, "flash")
    assert ta.LAUNCHES["flash_fwd_f32"] == 1
    assert ta.LAUNCHES["flash_dq_f32"] == ta.LAUNCHES["flash_dkv_f32"] == 0


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


# the most of the f16 forward's outputs that may differ from the plain
# version's (chip_smoke.py's SHARE_BAR, where the bars are argued): K1
# against the plain version, K2 against it over the kernel's key tiles
F16_FWD_SHARE_BAR = {"splash": 0.01, "flash": 0.05}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("impl", ["splash", "flash"])
@pytest.mark.parametrize("batch,seq,hq,hkv,hd,fused", ERROR_RATIO_CASES)
def test_cuda_attention_kernels_error_ratio(cuda_device, impl, batch, seq, hq, hkv, hd, fused,
                                            dtype):
    """Forward, dq and dk/dv kernels (attention.cu's wgmma kernels) against
    an f32 evaluation of the same bf16 or f16 inputs: each output's max abs
    error is at most twice the plain version's in that dtype (the two round
    at the same places), and lse is within 1e-3. In f16, at most
    ``F16_FWD_SHARE_BAR`` of the forward's outputs differ from the plain
    version's: the max-abs bar cannot see where P is rounded, this share
    can."""
    g = torch.Generator().manual_seed(batch * 1000 + seq + hq * 10 + hd)
    q = torch.randn(batch, seq, hq, hd, generator=g).to(cuda_device, dtype)
    if fused:
        kv = torch.randn(batch, seq, 2 * hkv, hd, generator=g).to(cuda_device, dtype)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        assert not k.is_contiguous()
    else:
        k, v = (torch.randn(batch, seq, hkv, hd, generator=g).to(cuda_device, dtype)
                for _ in range(2))
    if impl == "splash":
        q, sm = q * ta.splash_scale(hd, q.dtype), 1.0
    else:
        sm = hd ** -0.5
    f32 = [x.float() for x in (q, k, v)]
    o_p, lse_p = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    o_32, lse_32 = ta.attention_fwd_plain(*f32, sm, True)
    do = (2 * o_p.float()).to(dtype)
    args = (q, k, v, lse_p, ta.attention_delta(o_p, do), do, sm)
    args_32 = (*f32, lse_32, ta.attention_delta(o_32, do.float()), do.float(), sm)
    ta.reset_launches()
    o_k, lse_k = ta.attention_fwd(q, k, v, sm, impl)
    dq_k = ta.attention_dq(*args, impl)
    dk_k, dv_k = ta.attention_dkv(*args, impl)
    torch.cuda.synchronize()
    suffix = "_f16" if dtype == torch.float16 else ""
    assert {n: c for n, c in ta.LAUNCHES.items() if c} == {
        f"{impl}_fwd{suffix}": 1, f"{impl}_dq{suffix}": 1, f"{impl}_dkv{suffix}": 1}
    assert _max_err(lse_k, lse_32) <= 1e-3
    if dtype == torch.float16:
        same_points = o_p if impl == "splash" else ta.attention_fwd_plain(
            q, k, v, sm, False, ta.FWD_KEY_TILE[hd])[0]
        share = float((o_k != same_points).float().mean())
        assert share <= F16_FWD_SHARE_BAR[impl], share
    dk_p, dv_p = ta.attention_dkv_plain(*args)
    dk_32, dv_32 = ta.attention_dkv_plain(*args_32)
    for name, got, plain, ref in (
        ("o", o_k, o_p, o_32),
        ("dq", dq_k, ta.attention_dq_plain(*args), ta.attention_dq_plain(*args_32)),
        ("dk", dk_k, dk_p, dk_32),
        ("dv", dv_k, dv_p, dv_32),
    ):
        assert got.shape == plain.shape and got.dtype == dtype, name
        assert bool(torch.isfinite(got).all()), name
        assert _max_err(got, ref) <= 2 * _max_err(plain, ref), name


def _attention_f64(q, k, v, do, sm):
    """(o, lse, (dq, dk, dv)) in f64 by autograd through a causal softmax
    attention with K/V repeated per group: the f32 kernels' reference."""
    group = q.shape[2] // k.shape[2]
    leaves = [x.detach().double().requires_grad_() for x in (q, k, v)]
    qf = leaves[0].transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(group, 1) for x in leaves[1:])
    s = (qf @ kf.transpose(-1, -2)) * sm
    S = s.shape[-1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=s.device).tril(), float("-inf"))
    o = (torch.softmax(s, -1) @ vf).transpose(1, 2)
    return o.detach(), torch.logsumexp(s, -1).detach(), torch.autograd.grad(o, leaves, do.double())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,hq,hkv,hd,fused", ERROR_RATIO_CASES)
@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_cuda_tf32x3_attention_kernels_error_ratio(cuda_device, impl, batch, seq, hq, hkv, hd,
                                                   fused):
    """The f32 kernels, the 3xTF32 forward, dq and dk/dv
    (attention_tf32x3.cu), within 4x the plain f32 version's error against
    an f64 evaluation (the forward's online softmax rounds its sums once
    more per key tile than the plain version; the split operands drop
    lo*lo and the tensor-core sums keep ~22-23 bits), TF32 off for the
    plain version; lse within 1e-3. (bf16 and f16 run attention.cu, held in
    test_cuda_attention_kernels_error_ratio.)"""
    assert not torch.backends.cuda.matmul.allow_tf32
    dtype = torch.float32
    g = torch.Generator().manual_seed(batch * 1000 + seq + hq * 10 + hd)
    q = torch.randn(batch, seq, hq, hd, generator=g).to(cuda_device, dtype)
    if fused:
        kv = torch.randn(batch, seq, 2 * hkv, hd, generator=g).to(cuda_device, dtype)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    else:
        k, v = (torch.randn(batch, seq, hkv, hd, generator=g).to(cuda_device, dtype)
                for _ in range(2))
    if impl == "splash":
        q, sm = q * ta.splash_scale(hd, q.dtype), 1.0
    else:
        sm = hd ** -0.5
    o_p, lse_p = ta.attention_fwd_plain(q, k, v, sm, impl == "splash")
    do = (2 * o_p.float()).to(dtype)
    args = (q, k, v, lse_p, ta.attention_delta(o_p, do), do, sm)
    o_r, lse_r, (dq_r, dk_r, dv_r) = _attention_f64(q, k, v, do, sm)
    ta.reset_launches()
    o_k, lse_k = ta.attention_fwd(q, k, v, sm, impl)
    dq_k = ta.attention_dq(*args, impl)
    dk_k, dv_k = ta.attention_dkv(*args, impl)
    torch.cuda.synchronize()
    assert {n: c for n, c in ta.LAUNCHES.items() if c} == {
        f"{impl}_fwd_f32": 1, f"{impl}_dq_f32": 1, f"{impl}_dkv_f32": 1}
    assert _max_err(lse_k, lse_r) <= 1e-3
    dk_p, dv_p = ta.attention_dkv_plain(*args)
    for name, got, plain, ref in (
        ("o", o_k, o_p, o_r),
        ("dq", dq_k, ta.attention_dq_plain(*args), dq_r),
        ("dk", dk_k, dk_p, dk_r),
        ("dv", dv_k, dv_p, dv_r),
    ):
        assert got.shape == plain.shape and got.dtype == dtype, name
        assert bool(torch.isfinite(got).all()), name
        e_k = float((got.double() - ref.double()).abs().max())
        e_p = float((plain.double() - ref.double()).abs().max())
        assert e_k <= 4 * e_p, (name, e_k, e_p)


# the attention kernel instances a 64-head-dim model runs, per dtype
ROUTED_INSTANCES = {
    torch.float32: {"tf32x3_fwd_kernel<64>", "tf32x3_dq_kernel<64>", "tf32x3_dkv_kernel<64>"},
    torch.float16: {"attention_fwd_kernel<64,{split},__half>", "attention_dq_kernel<64,__half>",
                    "attention_dkv_kernel<64,__half>"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("impl", ["auto", "splash", "flash"])
def test_cuda_f32_and_f16_run_only_their_routed_kernels(cuda_device, dtype, impl):
    """An f32/f16 model on the card at a shape the kernels tile runs the
    kernels, forward and backward, as the reference's rule runs its kernels
    on any dtype: f32 the 3xTF32 kernels of attention_tf32x3.cu, f16
    attention.cu's wgmma kernels; a profile of the run shows exactly those
    instances.
    Output and gradients match the plain path's.
    Tolerance: f32 1e-4 (f32 sums in another order), f16 1e-2 (both round
    O, P, dS and the gradients to f16 at values up to ~8, and may round
    one element to neighbouring f16 values). impl="xla" still runs the
    materialized path, launching nothing."""
    from torch.profiler import ProfilerActivity, profile

    want = "splash" if impl == "auto" else impl
    plain = ta.splash_attention_plain if want == "splash" else ta.flash_attention_plain
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    results = []
    for fn in (lambda q, k, v: ta.causal_attention(q, k, v, impl=impl), plain):
        g = torch.Generator().manual_seed(7)
        q, k, v = (torch.randn(1, 128, h, 64, generator=g).to(cuda_device, dtype).requires_grad_()
                   for h in (4, 2, 2))
        ta.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn(q, k, v)
            (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
        ran = {e.key for e in prof.key_averages() if e.self_device_time_total > 0}
        results.append((dict(ta.LAUNCHES), [out.detach(), q.grad, k.grad, v.grad], ran))
    (launched, got, ran), (plain_launched, ref, _) = results
    assert ta.LAST_DISPATCH == want
    suffix = "_f32" if dtype == torch.float32 else "_f16"
    assert {n: c for n, c in launched.items() if c} == {
        f"{want}_fwd{suffix}": 1, f"{want}_dq{suffix}": 1, f"{want}_dkv{suffix}": 1}
    assert not any(plain_launched.values())
    kernels = {m.group(0).replace(" ", "") for key in ran
               for m in [re.search(r"(?:attention|tf32x3)_(?:fwd|dq|dkv)_kernel<[^>]*>", key)]
               if m}
    want_ran = {name.format(split=str(want == "splash").lower()) for name in ROUTED_INSTANCES[dtype]}
    assert kernels == want_ran, kernels
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol, msg=name)
    q, k, v = (x.detach() for x in (q, k, v))
    ta.reset_launches()
    out = ta.causal_attention(q, k, v, impl="xla")
    assert ta.LAST_DISPATCH == "xla"
    assert not any(ta.LAUNCHES.values())
    torch.testing.assert_close(out, ta.xla_attention(q, k, v), rtol=0, atol=0)


def _rs_two_ranks(inputs, op, prefix):
    """reduce_scatter_quantized of ``inputs[r]`` on ranks 0 and 1 of a host
    process group (threads); each rank's chunk on the CPU, or its error."""
    import threading

    from torchft_tpu_torch.collectives import reduce_scatter_quantized
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost

    store = KvStoreServer("127.0.0.1:0")
    out = [None, None]

    def rank(r):
        pg = ProcessGroupHost(timeout=60)
        try:
            pg.configure(f"127.0.0.1:{store.port}/{prefix}", r, 2)
            out[r] = reduce_scatter_quantized([inputs[r]], op, pg).get_future().wait(60).cpu()
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[r] = e
        finally:
            pg.shutdown()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    store.shutdown()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["SUM", "AVG"])
def test_cuda_reduce_scatter_quantized_matches_cpu(cuda_device, op):
    """The device engine on CUDA tensors (one quantize and one dequantize
    launch a rank) against the same call on CPU tensors, bit for bit."""
    from torchft_tpu_torch.process_group import ReduceOp

    g = torch.Generator().manual_seed(11)
    inputs = [torch.randn(512 * 300 + 77, generator=g) * 10 for _ in range(2)]
    inputs[0][:512] = 0.0
    inf_at = 600
    inputs[1][inf_at] = float("inf")
    tq.reset_launches()
    card = _rs_two_ranks([x.to(cuda_device) for x in inputs], ReduceOp[op], f"rs_cuda_{op}")
    assert tq.LAUNCHES["quantize_fp8_rowwise"] == 2 and tq.LAUNCHES["dequantize_fp8_rowwise"] == 2
    cpu = _rs_two_ranks(inputs, ReduceOp[op], f"rs_cpu_{op}")
    # rank 0's chunk is whole rows: the inf's rank and row within it
    inf_rank, inf_off = divmod(inf_at, card[0].numel())
    for r, (a, b) in enumerate(zip(card, cpu)):
        assert isinstance(a, torch.Tensor) and a.shape == b.shape
        # the inf's row decodes to NaNs, whose payloads may differ; no
        # other element is NaN
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        rows = torch.unique(nan.nonzero().flatten() // 512).tolist()
        assert rows == ([inf_off // 512] if r == inf_rank else []), (r, rows)
        differ = (a[~nan].view(torch.int32) != b[~nan].view(torch.int32)).nonzero().flatten()
        assert differ.numel() == 0, (r, differ[:8].tolist())


@pytest.mark.cuda
def test_cuda_reduce_scatter_build_failure_raises(cuda_device, monkeypatch, tmp_path):
    """A broken fp8_rowwise.cu fails reduce_scatter_quantized's Work with
    nvcc's output: no plain version, no host engine in its place."""
    from torchft_tpu_torch.ops import _build
    from torchft_tpu_torch.process_group import ReduceOp

    (tmp_path / "fp8_rowwise.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    tq._kernels.cache_clear()
    try:
        tq.reset_launches()
        out = _rs_two_ranks([torch.ones(2048, device=cuda_device)] * 2, ReduceOp.SUM, "rs_broken")
        for e in out:
            assert isinstance(e, RuntimeError) and "nvcc failed" in str(e)
        assert not any(tq.LAUNCHES.values())
    finally:
        tq._kernels.cache_clear()


@pytest.mark.cuda
def test_cuda_attention_ops_dispatch_to_the_kernels(cuda_device):
    """The ``torchft_tpu_torch::attention_fwd`` / ``::attention_bwd`` ops on
    CUDA tensors launch the kernels through their wrappers, bit for bit the
    wrappers' outputs; ``plain=True`` runs the plain versions there and
    launches nothing. ``opcheck`` passes on the CUDA registrations."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 256, h, 64, generator=g).to(cuda_device, torch.bfloat16)
               for h in (4, 2, 2))
    ta.reset_launches()
    o, lse = ta.attention_fwd_op(q, k, v, 1.0, "splash", False)
    do = torch.randn_like(o)
    dq, dk, dv = ta.attention_bwd_op(q, k, v, o, lse, do, 1.0, "splash", False)
    torch.cuda.synchronize()
    assert {n: c for n, c in ta.LAUNCHES.items() if c} == {
        "splash_fwd": 1, "splash_dq": 1, "splash_dkv": 1}
    wo, wlse = ta.attention_fwd(q, k, v, 1.0, "splash")
    delta = ta.attention_delta(wo, do)
    assert torch.equal(o, wo) and torch.equal(lse, wlse)
    assert torch.equal(dq, ta.attention_dq(q, k, v, wlse, delta, do, 1.0, "splash"))
    wdk, wdv = ta.attention_dkv(q, k, v, wlse, delta, do, 1.0, "splash")
    assert torch.equal(dk, wdk) and torch.equal(dv, wdv)
    ta.reset_launches()
    po, plse = ta.attention_fwd_op(q, k, v, 1.0, "splash", True)
    torch.cuda.synchronize()
    assert not any(ta.LAUNCHES.values())
    assert torch.equal(po, ta.attention_fwd_plain(q, k, v, 1.0, True)[0].contiguous())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.library.opcheck(ta.attention_fwd_op, (*leaves, 1.0, "splash", False))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,forwards", [("none", 1), ("dots", 1), ("attn", 1), ("full", 2)])
def test_cuda_remat_modes_launch_the_forward_once_a_layer(cuda_device, mode, forwards):
    """A 2-layer bf16 Llama with head dim 64 on the card under each remat
    mode: K1's forward launches once a layer (twice under "full"), dq and
    dK/dV once; the loss and every gradient bitwise equal to "none"'s."""
    import dataclasses

    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    cfg = dataclasses.replace(CONFIGS["debug"], dim=256, n_heads=4, n_kv_heads=2,
                              dtype=torch.bfloat16)
    model = Llama(cfg, device=cuda_device, remat="none")
    model.init_weights(torch.Generator(device=cuda_device).manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (2, 129),
                         generator=torch.Generator(device=cuda_device).manual_seed(6),
                         device=cuda_device)
    runs = []
    for m in ("none", mode):
        model.remat = m
        model.zero_grad(set_to_none=True)
        ta.reset_launches()
        loss = model.loss(toks[:, :-1], toks[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), [p.grad.clone() for p in model.parameters()],
                     dict(ta.LAUNCHES)))
    (base_loss, base_grads, _), (loss, grads, launched) = runs
    assert {n: c for n, c in launched.items() if c} == {
        "splash_fwd": forwards * cfg.n_layers, "splash_dq": cfg.n_layers,
        "splash_dkv": cfg.n_layers}
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base_grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_reconstruct_lands_in_a_cuda_template_in_place(cuda_device):
    """The redundancy plane's heal: shards staged from a CUDA state (the
    blob's device-to-host snapshot), a data holder dead, the decode through
    parity, and the leaves landed in a CUDA template: bitwise, with every
    tensor's data_ptr() kept."""
    from torchft_tpu_torch import redundancy as rd
    from torchft_tpu_torch.checkpointing.erasure import encode_shards, shard_crc

    g = torch.Generator(device=cuda_device).manual_seed(0)

    def state():
        return {"w": torch.randn(257, 129, generator=g, device=cuda_device).to(torch.bfloat16),
                "m": torch.randn(1000, generator=g, device=cuda_device),
                "step": torch.tensor(4.0), "lr": 3e-4}

    src, template = state(), state()
    ptrs = [template["w"].data_ptr(), template["m"].data_ptr(), template["step"].data_ptr()]
    directory = rd.ShardDirectory(poll_s=0.05, dead_after_s=60.0)
    stores = [rd.ShardStore(f"h{i}") for i in range(3)]
    try:
        blob = rd.pack_state_blob(src)
        epoch = directory.register("own", "pod0", "", False)[1]["epoch"]
        entries = []
        for i, (shard, store) in enumerate(zip(encode_shards(blob, 2, 1), stores)):
            store.put("own", 3, i, bytes(shard))
            entries.append({"idx": i, "crc": shard_crc(shard), "url": store.url,
                            "holder": store.replica_id})
        assert directory.announce({"replica_id": "own", "epoch": epoch, "seq": 1, "step": 3,
                                   "k": 2, "m": 1, "data_len": len(blob),
                                   "shards": entries})[0] == 200
        stores[0].shutdown()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        step, got, stats = rd.reconstruct_state(directory.url, owner="own", timeout=10.0,
                                                template=template)
        torch.cuda.synchronize()
    finally:
        for s in stores:
            s.shutdown()
        directory.shutdown()
    assert step == 3 and stats["shards_failed"] == 1
    assert [got["w"].data_ptr(), got["m"].data_ptr(), got["step"].data_ptr()] == ptrs
    assert got["w"].device == cuda_device
    assert torch.equal(got["w"].view(torch.int16), src["w"].view(torch.int16))
    assert torch.equal(got["m"].view(torch.int32), src["m"].view(torch.int32))
    assert float(got["step"]) == 4.0 and got["lr"] == 3e-4
    # the heal allocated no second copy of the state on the card
    assert torch.cuda.memory_allocated() == allocated


@pytest.mark.cuda
def test_cuda_serving_chain_equals_the_cpu_chain_and_is_not_torn(cuda_device):
    """The serving plane on the card: a publisher over CUDA parameters
    (``publish_async``: the copy on the training stream queued behind a
    long spin, the parameters written in place right after, as the next
    optimizer step does) and a worker on the card land, version after
    version, on the ``R`` a CPU publisher computes from the published
    values, bit for bit (K3-host and K4 against the host codec); the
    publisher coded each version with one K3-host launch and replayed it
    with K4, and the worker decoded each delta with K4."""
    from torchft_tpu_torch import serving

    reg = serving.SnapshotRegistry()
    cfg = serving.ServeConfig(registry=reg.url, compress="fp8", poll_s=0.01, timeout_s=30.0)
    pub = serving.SnapshotPublisher("card", config=cfg, registry_url=reg.url)
    cpu_pub = serving.SnapshotPublisher("host", config=serving.ServeConfig(
        compress="fp8", timeout_s=30.0), registry_url="")
    worker = serving.ServeWorker(reg.url, config=cfg, name="w", start=False, device=cuda_device)
    try:
        gen = torch.Generator().manual_seed(17)
        w = torch.randn(3 * 2**20 + 77, generator=gen).to(cuda_device)
        b = torch.randn(1000, generator=gen).to(cuda_device, torch.bfloat16)
        for step in range(4):
            torch.cuda._sleep(50_000_000)
            pub.publish_async(1, step, {"w": w, "b": b})
            sent = {"w": w.clone().cpu(), "b": b.clone().cpu()}
            w.mul_(0.9).add_(0.01)
            b.add_(0.5)
            assert cpu_pub.publish(1, step, sent) == (1, step)
            assert pub.flush(30.0)
            assert worker.pull_once() and worker.version == (1, step)
            want = cpu_pub.ref_flat()
            assert torch.equal(pub.ref_flat().cpu(), want)
            assert torch.equal(worker.params_flat().cpu(), want)
        assert pub.counters["published_total"] == 4 and pub.counters["skipped_total"] == 0
        assert pub.counters["k3_host_launches"] == 4 and pub.counters["k4_launches"] >= 4
        assert worker.counters["delta_pulls_total"] == 3 and worker.counters["k4_launches"] >= 3
    finally:
        worker.shutdown()
        pub.shutdown()
        cpu_pub.shutdown()
        reg.shutdown()


@pytest.mark.cuda
def test_cuda_host_rule_codes_a_row_without_a_finite_reciprocal_as_zero(cuda_device):
    """A row whose scale (amax / 448) has no finite reciprocal, as error
    feedback leaves a fading row: the host-rule kernel, its plain version
    and the port's numpy codec all code it as a zero row (scale 1, codes
    +-0); the rows beside it keep the reference's rule."""
    x = torch.randn(3 * 512, generator=torch.Generator().manual_seed(5))
    x[512:1024] *= 1e-38
    qk, sk, nk = tq.fused_quantize_fp8_host(x.to(cuda_device))
    qp, sp, _ = tq.quantize_fp8_host_plain(x)
    qh, sh, _ = tq.quantize_fp8_rowwise(x.numpy())
    assert torch.equal(qk.view(torch.uint8).cpu(), qp.view(torch.uint8))
    assert torch.equal(sk.cpu(), sp)
    assert (qk.view(torch.uint8).cpu().numpy() == qh).all()
    assert sk[1].item() == 1.0 and not (qk[1].view(torch.uint8) & 0x7F).any()
    assert torch.isfinite(tq.fused_dequantize_fp8(qk, sk, nk)).all()


@pytest.mark.cuda
def test_cuda_baby_heal_lands_in_cuda_templates_in_place(cuda_device):
    """A heal of CUDA state over PGTransport on two spawned Baby process
    groups: the leaves cross the children's pipes as host arrays and land
    in the receiver's CUDA tensors, bit for bit, storage kept; the parent
    alone holds the card, and every child is reaped."""
    import multiprocessing as mp
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.checkpointing import PGTransport
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupBabyHost

    g = torch.Generator(device=cuda_device).manual_seed(3)
    state = {"user": {"w": torch.randn(1024, 1024, device=cuda_device, generator=g),
                      "b": torch.randn(4096, device=cuda_device, generator=g).bfloat16(),
                      "n": torch.arange(7)},
             "torchft": {"step": 5, "batches_committed": 10}}
    template = {"user": {k: torch.zeros_like(v) for k, v in state["user"].items()},
                "torchft": {"step": 0, "batches_committed": 0}}
    ptrs = {k: v.data_ptr() for k, v in template["user"].items()}
    store = KvStoreServer("127.0.0.1:0")
    ctx = mp.get_context("spawn")
    pgs = [ProcessGroupBabyHost(timeout=60.0, ctx=ctx) for _ in range(2)]
    try:
        addr = f"127.0.0.1:{store.port}/cuda_baby"
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(lambda r: pgs[r].configure(addr, r, 2, 1), range(2)))
            sender = PGTransport(pgs[0], timeout=60.0)
            receiver = PGTransport(pgs[1], timeout=60.0, state_dict_template=lambda: template)
            fs = ex.submit(sender.send_checkpoint, [1], 5, state, 60.0)
            fr = ex.submit(receiver.recv_checkpoint, 0, "<pg_transport>", 5, 60.0)
            fs.result(timeout=120)
            out = fr.result(timeout=120)
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
    for k, v in state["user"].items():
        assert out["user"][k].device == v.device and out["user"][k].dtype == v.dtype
        assert torch.equal(out["user"][k], v), k
    assert {k: v.data_ptr() for k, v in template["user"].items() if v.is_cuda} == \
        {k: p for k, p in ptrs.items() if template["user"][k].is_cuda}
    assert out["torchft"] == state["torchft"]
    assert mp.active_children() == []
