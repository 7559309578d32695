"""Causal GQA attention for the Llama trainer.

Counterpart of ``torchft_tpu/ops/attention.py``. Layout: q [B, S, Hq, hd],
k/v [B, S, Hkv, hd] (Hq a multiple of Hkv), causal, scaled by 1/sqrt(hd);
output [B, S, Hq, hd].

``causal_attention`` dispatches like the reference (``:199-227``):

- ``"xla"``: the materialized path (f32 scores and softmax, repeated K/V),
  the counterpart of ``xla_attention``;
- ``"splash"`` (K1, ``splash_attention_tpu``) and ``"flash"`` (K2,
  ``flash_attention_tpu``): the fused kernels of ``csrc/attention.cu``,
  forward and backward, reading GQA K/V heads in place (no repeat);
- ``"auto"``: on a CUDA tensor ``"splash"`` when Hq != Hkv, else
  ``"flash"``; ``"xla"`` on a CPU tensor (as the reference does off the
  TPU).
- On a CUDA tensor at a shape the kernels do not tile (S % 128, hd not
  in 64/128/256), every choice resolves to ``"xla"``, as the reference's
  rule does. At a shape they tile, a dtype other than bf16 raises
  ``TypeError`` for every choice but ``"xla"``: the kernels are bf16 only,
  and the materialized path does not stand in for them.

The kernel wrappers (``attention_fwd``, ``attention_dq``,
``attention_dkv``) launch the CUDA kernels on a CUDA tensor, counting each
launch in ``LAUNCHES``, and run the plain torch version below on a CPU
tensor. A failed build, tile map or launch raises; a CUDA tensor the
kernels do not take (not bf16, misaligned) raises rather than falling
back.

The two fused paths differ where the references do:

- K1 rounds 1/sqrt(hd) to q's dtype and multiplies q by it before the
  kernel (``attention.py:161-163``; the product stays on the autograd graph,
  so dq is scaled by the same constant), then runs the kernel with
  ``sm_scale`` 1; the forward keeps P in f32 for P.V (the kernel carries it
  as a bf16 hi + lo pair);
- K2 multiplies the f32 scores by ``sm_scale`` = 1/sqrt(hd) inside the
  kernel, rounds P to bf16 for P.V, and scales dS by ``sm_scale``.

Both backwards recompute P = exp(s - lse) from the forward's f32
logsumexp, take delta = rowsum(O * dO) in f32 (``splash_attention_kernel.py
:2285``), and round P and dS to the input dtype for their matmuls, summing
in f32. Masked scores take the reference's -0.7 * f32max, not -inf.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "causal_attention",
    "xla_attention",
    "splash_attention",
    "flash_attention",
    "splash_attention_plain",
    "flash_attention_plain",
    "attention_fwd",
    "attention_dq",
    "attention_dkv",
    "attention_fwd_plain",
    "attention_dq_plain",
    "attention_dkv_plain",
    "attention_delta",
    "resolve_impl",
    "KERNEL_HEAD_DIMS",
    "LAST_DISPATCH",
    "LAUNCHES",
    "reset_launches",
]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# head dims and the dtype the kernels are built for, and the sequence
# tiling they need (the reference's rule, attention.py:218); SEQ_TILE is a
# multiple of the kernels' own tile (``tft_attention_tile``)
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPE = torch.bfloat16
SEQ_TILE = 128
# what a kernel entry point returns, besides CUDA error codes
_STATUS = {-1: "a head dim it was not built for", -2: "libcuda has no cuTensorMapEncodeTiled",
           -3: "cuTensorMapEncodeTiled refused a tile map"}

# which implementation the last causal_attention call resolved to
LAST_DISPATCH: Optional[str] = None

# kernel launches per (path, kernel), counted only where a kernel launches
LAUNCHES: Dict[str, int] = {
    f"{impl}_{kernel}": 0 for impl in ("splash", "flash") for kernel in ("fwd", "dq", "dkv")
}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    groups = q.shape[2] // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    return k, v


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None) -> torch.Tensor:
    """Materialized causal GQA attention: f32 scores, causal mask, f32
    softmax, probabilities cast back to the input dtype."""
    hd = q.shape[-1]
    k, v = _repeat_kv(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    S = q.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels' arithmetic ([B, H, S, S] in f32)
# ---------------------------------------------------------------------------
def _heads_f32(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """[B, S, H, hd] -> f32 [B, H*group, S, hd] (K/V repeated per group)."""
    x = x.transpose(1, 2).to(torch.float32)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _masked_scores(qf: torch.Tensor, kf: torch.Tensor, sm_scale: float) -> torch.Tensor:
    s = qf @ kf.transpose(-1, -2)
    if sm_scale != 1.0:
        s = s * sm_scale
    S = s.shape[-1]
    causal = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~causal, MASK_VALUE)


def attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, p_f32: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S, Hq, hd] in q's dtype, lse f32 [B, Hq, S]). ``p_f32`` keeps
    P in f32 for P.V (splash); else P is rounded to q's dtype (flash)."""
    group = q.shape[2] // k.shape[2]
    qf, kf, vf = _heads_f32(q), _heads_f32(k, group), _heads_f32(v, group)
    s = _masked_scores(qf, kf, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if not p_f32:
        p = p.to(q.dtype).to(torch.float32)
    o = (p @ vf) * (1.0 / l)
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(O * dO) in f32: [B, S, Hq, hd] -> [B, Hq, S]."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, lse, delta, do, sm_scale):
    """P = exp(s - lse) and dS = (dO V^T - delta) * P * sm_scale, f32
    [B, Hq, S, S], plus the f32 [B, Hq, S, hd] views of q, k, dO."""
    group = q.shape[2] // k.shape[2]
    qf, kf, vf, dof = _heads_f32(q), _heads_f32(k, group), _heads_f32(v, group), _heads_f32(do)
    p = torch.exp(_masked_scores(qf, kf, sm_scale) - lse[..., None])
    ds = (dof @ vf.transpose(-1, -2) - delta[..., None]) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    return p, ds, qf, kf, dof


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32: a matmul operand."""
    return x.to(dtype).to(torch.float32)


def attention_dq_plain(q, k, v, lse, delta, do, sm_scale: float) -> torch.Tensor:
    """dq [B, S, Hq, hd] in q's dtype: dS (rounded to the input dtype) @ K."""
    _, ds, _, kf, _ = _probs_and_ds(q, k, v, lse, delta, do, sm_scale)
    return (_round(ds, q.dtype) @ kf).transpose(1, 2).to(q.dtype)


def attention_dkv_plain(q, k, v, lse, delta, do, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, S, Hkv, hd] in k's dtype: P^T dO and dS^T Q per query
    head (P, dS rounded to the input dtype), summed over each KV head's
    group in f32 and rounded once."""
    p, ds, qf, _, dof = _probs_and_ds(q, k, v, lse, delta, do, sm_scale)
    B, Hkv, hd = k.shape[0], k.shape[2], k.shape[3]
    S = q.shape[1]

    def per_kv_head(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, Hkv, -1, S, hd).sum(dim=2).transpose(1, 2).to(k.dtype)

    dv = _round(p, q.dtype).transpose(-1, -2) @ dof
    dk = _round(ds, q.dtype).transpose(-1, -2) @ qf
    return per_kv_head(dk), per_kv_head(dv)


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA kernels for CUDA tensors, plain versions on the CPU
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _kernels() -> ctypes.CDLL:
    from torchft_tpu_torch.ops._build import load_library

    lib = load_library("attention.cu")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [ci, ci, ci, ci, ci, cf]  # B, S, Hq, Hkv, hd, sm_scale
    lib.tft_attention_fwd.argtypes = [vp] * 6 + dims + [ci, vp]
    lib.tft_attention_dq.argtypes = [vp] * 8 + dims + [vp]
    lib.tft_attention_dkv.argtypes = [vp] * 9 + dims + [vp]
    for fn in (lib.tft_attention_fwd, lib.tft_attention_dq, lib.tft_attention_dkv,
               lib.tft_attention_tile):
        fn.restype = ci
    if SEQ_TILE % lib.tft_attention_tile():
        raise RuntimeError(f"SEQ_TILE {SEQ_TILE} is not a multiple of the kernels' tile "
                           f"{lib.tft_attention_tile()}")
    return lib


def _check_inputs(*tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: bf16 [B, S, H, hd] on one
    CUDA device, head dim contiguous, 16-byte aligned rows and strides (as
    TMA needs)."""
    q = tensors[0]
    B, S, _, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take head dims {KERNEL_HEAD_DIMS}, got {hd}")
    tile = _kernels().tft_attention_tile()
    if S % tile != 0:
        raise ValueError(f"the attention kernels need seq_len % {tile} == 0, got {S}")
    for x in tensors:
        if x.dtype != KERNEL_DTYPE:
            raise TypeError(f"the attention kernels take bf16 tensors, got {x.dtype}")
        if x.device != q.device or x.dim() != 4 or x.shape[0] != B or x.shape[1] != S or x.shape[3] != hd:
            raise ValueError("attention tensors must be [B, S, H, hd] on one CUDA device")
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError("attention tensors need a contiguous, 16-byte aligned head dim")


def _strides(*tensors: torch.Tensor):
    flat = [st for x in tensors for st in x.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _launch(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"attention kernel {name} failed: "
                           f"{_STATUS.get(status, f'CUDA error {status}')}")
    _count(name)


def _dims(q: torch.Tensor, k: torch.Tensor, sm_scale: float):
    return (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], sm_scale)


def attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, impl: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention: ``attention_fwd_kernel`` on CUDA
    (counted as ``{impl}_fwd``), the plain version on the CPU. ``impl``
    "splash" keeps P in f32 for P.V, "flash" rounds it to bf16."""
    p_f32 = impl == "splash"
    if not q.is_cuda:
        return attention_fwd_plain(q, k, v, sm_scale, p_f32)
    _check_inputs(q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernels().tft_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), *_dims(q, k, sm_scale), int(p_f32), stream,
        )
    _launch(status, f"{impl}_fwd")
    return o, lse


def attention_dq(q, k, v, lse, delta, do, sm_scale: float, impl: str) -> torch.Tensor:
    """dq: ``attention_dq_kernel`` on CUDA (counted as ``{impl}_dq``), the
    plain version on the CPU."""
    if not q.is_cuda:
        return attention_dq_plain(q, k, v, lse, delta, do, sm_scale)
    _check_inputs(q, k, v, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernels().tft_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _stat(lse, q).data_ptr(), _stat(delta, q).data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), *_dims(q, k, sm_scale), stream,
        )
    _launch(status, f"{impl}_dq")
    return dq


def attention_dkv(q, k, v, lse, delta, do, sm_scale: float, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): ``attention_dkv_kernel`` on CUDA (counted as
    ``{impl}_dkv``), the plain version on the CPU."""
    if not q.is_cuda:
        return attention_dkv_plain(q, k, v, lse, delta, do, sm_scale)
    _check_inputs(q, k, v, do)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernels().tft_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _stat(lse, q).data_ptr(), _stat(delta, q).data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), *_dims(q, k, sm_scale), stream,
        )
    _launch(status, f"{impl}_dkv")
    return dk, dv


def _stat(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A per-row statistic (lse, delta) as the kernels read it: f32
    [B, Hq, S] on q's device, contiguous and 16-byte aligned (the dK/dV
    kernel loads its rows by TMA); a strided or misaligned one is copied."""
    shape = (q.shape[0], q.shape[2], q.shape[1])
    if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != q.device:
        raise ValueError(f"row statistics must be f32 {shape} on {q.device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class _CausalAttention(torch.autograd.Function):
    """Causal attention through the kernel wrappers (or, with ``plain``, the
    plain versions on any device), saving q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, impl: str, plain: bool):
        if plain:
            o, lse = attention_fwd_plain(q, k, v, sm_scale, impl == "splash")
        else:
            o, lse = attention_fwd(q, k, v, sm_scale, impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, impl, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        sm_scale, impl, plain = ctx.args
        do = do.contiguous()
        delta = attention_delta(o, do)
        if plain:
            dq = attention_dq_plain(q, k, v, lse, delta, do, sm_scale)
            dk, dv = attention_dkv_plain(q, k, v, lse, delta, do, sm_scale)
        else:
            dq = attention_dq(q, k, v, lse, delta, do, sm_scale, impl)
            dk, dv = attention_dkv(q, k, v, lse, delta, do, sm_scale, impl)
        return dq, dk, dv, None, None, None


@functools.lru_cache(maxsize=8)
def splash_scale(hd: int, dtype: torch.dtype) -> float:
    """K1's query scale: 1/sqrt(hd) rounded to the input dtype, as the
    reference's ``jnp.asarray(scale, q.dtype)``."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K1: q pre-scaled in its own dtype, then the kernel with scale 1."""
    qs = q * splash_scale(q.shape[-1], q.dtype)
    return _CausalAttention.apply(qs, k, v, 1.0, "splash", plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K2: 1/sqrt(hd) applied to the f32 scores inside the kernel; GQA K/V
    read in place (the reference repeats them; dK/dV summed over the group
    is the transpose of that repeat)."""
    return _CausalAttention.apply(q, k, v, 1.0 / math.sqrt(q.shape[-1]), "flash", plain)


def splash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 through the plain versions, forward and backward, on any device."""
    return splash_attention(q, k, v, plain=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2 through the plain versions, forward and backward, on any device."""
    return flash_attention(q, k, v, plain=True)


def resolve_impl(impl: str, q_shape, kv_heads: int, cuda: bool, dtype: torch.dtype) -> str:
    """The implementation ``causal_attention`` runs for ``impl`` on a q of
    ``q_shape`` [B, S, Hq, hd] and ``dtype`` with ``kv_heads`` K/V heads,
    on a CUDA tensor or not. Raises ``TypeError`` where a kernel would run
    on a CUDA tensor that is not bf16."""
    if impl not in ("auto", "xla", "splash", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    S, hq, hd = q_shape[1], q_shape[2], q_shape[3]
    tileable = S % SEQ_TILE == 0 and hd in KERNEL_HEAD_DIMS
    if impl == "xla" or (cuda and not tileable) or (impl == "auto" and not cuda):
        return "xla"
    if cuda and dtype != KERNEL_DTYPE:
        raise TypeError(f"the attention kernels take bf16 tensors, got {dtype}: cast the "
                        "model to bf16, or pass impl='xla' for the materialized path")
    if impl == "auto":
        return "splash" if hq != kv_heads else "flash"
    return impl


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch to ``impl`` ("auto" | "xla" | "splash" | "flash") by
    ``resolve_impl``; an explicit "splash"/"flash" on a CPU tensor runs
    that kernel's plain version."""
    global LAST_DISPATCH
    LAST_DISPATCH = resolve_impl(impl, q.shape, k.shape[2], q.is_cuda, q.dtype)
    if LAST_DISPATCH == "xla":
        return xla_attention(q, k, v, cfg)
    if LAST_DISPATCH == "splash":
        return splash_attention(q, k, v)
    return flash_attention(q, k, v)
