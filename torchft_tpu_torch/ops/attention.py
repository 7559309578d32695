"""Causal GQA attention for the Llama trainer.

Counterpart of ``torchft_tpu/ops/attention.py``. Layout: q [B, S, Hq, hd],
k/v [B, S, Hkv, hd] (Hq a multiple of Hkv), causal, scaled by 1/sqrt(hd);
output [B, S, Hq, hd].

``causal_attention`` dispatches like the reference (``:199-227``):

- ``"xla"``: the materialized path (f32 scores and softmax, repeated K/V),
  the counterpart of ``xla_attention``;
- ``"splash"`` (K1, ``splash_attention_tpu``) and ``"flash"`` (K2,
  ``flash_attention_tpu``): the fused kernels, forward and backward,
  reading GQA K/V heads in place (no repeat). ``ROUTES`` says which source
  runs each (kernel, dtype): ``csrc/attention.cu`` (wgmma and TMA) every
  bf16 and f16 kernel, ``csrc/attention_tf32x3.cu`` (split operands, three
  TF32 tensor-core products per f32 one, wgmma fed by TMA) every f32 one;
- ``"auto"``: on a CUDA tensor ``"splash"`` when Hq != Hkv, else
  ``"flash"``; ``"xla"`` on a CPU tensor (as the reference does off the
  TPU).
- No choice passed (``impl=None``, the model's default): the choice is
  read from ``TORCHFT_TPU_ATTENTION`` on every call, ``"auto"`` if it is
  unset, as the reference reads it (``:217``); off the card every value
  of the variable resolves to ``"xla"``, as there. An unknown value raises
  ``ValueError`` (the reference would run flash). The reference's
  ``TORCHFT_TPU_SPLASH_BLOCK[_KV]`` set the Pallas splash tiles; the CUDA
  kernels' tiles are fixed, so they have no counterpart here.
- On a CUDA tensor at a shape the kernels do not tile (S % 128, hd not
  in 64/128/256), every choice resolves to ``"xla"``, as the reference's
  rule does. The rule has no dtype clause: at a shape they tile, bf16,
  f16 and f32 run a kernel, and a dtype no kernel takes (f64, ...) raises
  ``TypeError`` for every choice but ``"xla"``; the materialized path
  never stands in for a kernel.

The fused paths run as two custom ops of the dispatcher,
``torchft_tpu_torch::attention_fwd`` (-> o, lse) and ``::attention_bwd``
(-> dq, dk, dv), with fake and autograd registrations: the plain versions
are their CPU kernels, the kernel wrappers their CUDA kernels. The
materialized path's output passes through ``::attn_out``, an identity,
while autograd records.
Selective remat (``models/remat.py``) names the attention output by these
ops, as the reference names it by ``checkpoint_name``.

The kernel wrappers (``attention_fwd``, ``attention_dq``,
``attention_dkv``) launch the CUDA kernels on a CUDA tensor, counting each
launch in ``LAUNCHES``, and run the plain torch version below on a CPU
tensor; the launches of the f32/f16 kernels are counted under keys ending
in ``_f32``/``_f16``, whichever source runs them. A failed build, tile map
or launch raises; a CUDA tensor the kernels do not take (another dtype,
mixed dtypes, misaligned for TMA) raises rather than falling back.

The two fused paths differ where the references do:

- K1 rounds 1/sqrt(hd) to q's dtype and multiplies q by it before the
  kernel (``attention.py:161-163``; the product stays on the autograd graph,
  so dq is scaled by the same constant), then runs the kernel with
  ``sm_scale`` 1; the forward keeps P in f32 for P.V (the bf16 kernel
  carries it as a bf16 hi + lo pair, the f16 kernel as an f16 hi + lo pair
  of P * 2^15);
- K2 multiplies the f32 scores by ``sm_scale`` = 1/sqrt(hd) inside the
  kernel, rounds P to the input dtype for P.V, and scales dS by
  ``sm_scale``. The kernel, like the reference's flash kernel, rounds P at
  each key tile's running max; ``attention_fwd_plain`` rounds it at the
  row's final max unless given the kernel's ``FWD_KEY_TILE``.

Both backwards recompute P = exp(s - lse) from the forward's f32
logsumexp, take delta = rowsum(O * dO) in f32 (``splash_attention_kernel.py
:2285``), and round P and dS to the input dtype for their matmuls, summing
in f32. Masked scores take the reference's -0.7 * f32max, not -inf.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
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
    "attention_fwd_op",
    "attention_bwd_op",
    "attn_out",
    "resolve_impl",
    "ATTENTION_ENV",
    "KERNEL_HEAD_DIMS",
    "FWD_KEY_TILE",
    "KERNEL_DTYPES",
    "ROUTES",
    "LAST_DISPATCH",
    "LAUNCHES",
    "reset_launches",
]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# head dims and dtypes the kernels are built for, and the sequence tiling
# they need (the reference's rule, attention.py:218); SEQ_TILE is a multiple
# of both kernel families' own tiles.
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
SEQ_TILE = 128
# keys per K/V tile of attention.cu's forward, per head dim (FwdShape::kKeys):
# where K2's online softmax rounds P
FWD_KEY_TILE = {64: 128, 128: 128, 256: 64}
# (kernel, dtype) -> (source, the dtype code its entry point takes first).
# attention.cu: 0 bf16, 1 f16; attention_tf32x3.cu: 0 f32.
ROUTES = {
    ("fwd", torch.bfloat16): ("attention.cu", 0),
    ("dq", torch.bfloat16): ("attention.cu", 0),
    ("dkv", torch.bfloat16): ("attention.cu", 0),
    ("fwd", torch.float16): ("attention.cu", 1),
    ("dq", torch.float16): ("attention.cu", 1),
    ("dkv", torch.float16): ("attention.cu", 1),
    ("fwd", torch.float32): ("attention_tf32x3.cu", 0),
    ("dq", torch.float32): ("attention_tf32x3.cu", 0),
    ("dkv", torch.float32): ("attention_tf32x3.cu", 0),
}
# each source's C entry-point prefix; each has the three kernels
_SOURCES = {"attention.cu": "tft_attention", "attention_tf32x3.cu": "tft_tf32x3_attention"}
_LAUNCH_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32", torch.float16: "_f16"}
# the variable causal_attention reads its choice from when given none
ATTENTION_ENV = "TORCHFT_TPU_ATTENTION"
IMPLS = ("auto", "xla", "splash", "flash")
# what a kernel entry point returns, besides CUDA error codes
_STATUS = {-1: "a head dim it was not built for", -2: "libcuda has no cuTensorMapEncodeTiled",
           -3: "cuTensorMapEncodeTiled refused a tile map", -4: "a dtype it was not built for"}

# which implementation the last causal_attention call resolved to
LAST_DISPATCH: Optional[str] = None

# kernel launches per (path, kernel, dtype family: "" for bf16, "_f32",
# "_f16"), counted only where a kernel launches
LAUNCHES: Dict[str, int] = {
    f"{impl}_{kernel}{suffix}": 0 for suffix in _LAUNCH_SUFFIX.values()
    for impl in ("splash", "flash") for kernel in ("fwd", "dq", "dkv")
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, p_f32: bool,
    key_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S, Hq, hd] in q's dtype, lse f32 [B, Hq, S]). ``p_f32`` keeps
    P in f32 for P.V (splash); else P is rounded to q's dtype (flash), at
    the row's max. With ``key_tile``, an online softmax over tiles of that
    many keys instead, as the forward kernel runs it: P is taken (and
    rounded) at each tile's running max, and the sums are rescaled as the
    max grows."""
    group = q.shape[2] // k.shape[2]
    qf, kf, vf = _heads_f32(q), _heads_f32(k, group), _heads_f32(v, group)
    s = _masked_scores(qf, kf, sm_scale)
    if key_tile is None:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = (p if p_f32 else _round(p, q.dtype)) @ vf
    else:
        # every row's key 0 lies in the first tile: m is a real score from
        # the start, and a tile wholly above the diagonal adds 0
        m = s[..., :key_tile].amax(dim=-1, keepdim=True)
        l = acc = 0.0
        for k0 in range(0, s.shape[-1], key_tile):
            st = s[..., k0:k0 + key_tile]
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + (p if p_f32 else _round(p, q.dtype)) @ vf[..., k0:k0 + key_tile, :]
            m = m_new
    o = acc * (1.0 / l)
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
@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>`` (one of ``_SOURCES``), built at
    first use, its entry points (a dtype code first) bound."""
    from torchft_tpu_torch.ops._build import load_library

    lib = load_library(source)
    prefix = _SOURCES[source]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [ci, ci, ci, ci, ci, cf]  # B, S, Hq, Hkv, hd, sm_scale
    # pointers: fwd q, k, v, o, lse, strides (then p_split); dq q, k, v,
    # do, lse, delta, dq, strides; dkv dk and dv in dq's place
    argtypes = {"fwd": [ci] + [vp] * 6 + dims + [ci, vp],
                "dq": [ci] + [vp] * 8 + dims + [vp],
                "dkv": [ci] + [vp] * 9 + dims + [vp]}
    for kernel, types in argtypes.items():
        fn = getattr(lib, f"{prefix}_{kernel}")
        fn.argtypes, fn.restype = types, ci
    tile = getattr(lib, f"{prefix}_tile")
    tile.restype = ci
    _check_tile(tile())
    return lib


def _check_tile(tile: int) -> None:
    """A library's kernels tile the sequence by ``tile`` rows: every S
    the dispatch rule (``SEQ_TILE``) admits must be a multiple of it."""
    if SEQ_TILE % tile:
        raise RuntimeError(f"SEQ_TILE {SEQ_TILE} is not a multiple of the kernels' tile {tile}")


def _entry(kernel: str, dtype: torch.dtype):
    """The C entry point of ``kernel`` ("fwd", "dq", "dkv") for ``dtype``
    by ``ROUTES``, its dtype code bound. Builds the library at first use."""
    source, code = ROUTES[(kernel, dtype)]
    return functools.partial(getattr(_library(source), f"{_SOURCES[source]}_{kernel}"), code)


def _dtype_names(dtypes=KERNEL_DTYPES) -> str:
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def _check_inputs(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise on what ``kernel`` ("fwd", "dq", "dkv") does not take:
    [B, S, H, hd] tensors of one dtype of ``KERNEL_DTYPES`` on one CUDA
    device, head dim contiguous, aligned as TMA reads them: every kernel
    loads its tiles by TMA, which needs a 16-byte aligned base and
    batch/sequence/head strides of whole 16 bytes (8 bf16/f16 or 4 f32
    elements)."""
    q = tensors[0]
    B, S, _, hd = q.shape
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the attention kernels take {_dtype_names()} tensors, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take head dims {KERNEL_HEAD_DIMS}, got {hd}")
    if S % SEQ_TILE != 0:
        raise ValueError(f"the attention kernels need seq_len % {SEQ_TILE} == 0, got {S}")
    source = ROUTES[(kernel, q.dtype)][0]
    for x in tensors:
        if x.dtype != q.dtype:
            raise TypeError(f"attention tensors must share one dtype, got {q.dtype} and {x.dtype}")
        if x.device != q.device or x.dim() != 4 or x.shape[0] != B or x.shape[1] != S or x.shape[3] != hd:
            raise ValueError("attention tensors must be [B, S, H, hd] on one CUDA device")
        if x.stride(3) != 1:
            raise ValueError("attention tensors need a contiguous head dim")
        per16 = 16 // x.element_size()
        if x.data_ptr() % 16 or any(st % per16 for st in x.stride()[:3]):
            raise ValueError(
                f"the {_dtype_names((q.dtype,))} attention {kernel} kernel ({source}) reads "
                f"by TMA: its tensors need a 16-byte aligned base and strides of whole 16 "
                f"bytes ({per16} elements)")


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


def _launch_name(impl: str, kernel: str, dtype: torch.dtype) -> str:
    return f"{impl}_{kernel}{_LAUNCH_SUFFIX[dtype]}"


def attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, impl: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention: ``attention_fwd_kernel`` (bf16/f16) or
    ``tf32x3_fwd_kernel`` (f32) on CUDA, counted as ``{impl}_fwd`` plus the
    dtype's suffix, the plain version on the CPU. ``impl`` "splash" keeps P
    in f32 for P.V, "flash" rounds it to the input dtype."""
    p_f32 = impl == "splash"
    if not q.is_cuda:
        return attention_fwd_plain(q, k, v, sm_scale, p_f32)
    _check_inputs("fwd", q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry("fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, o), *_dims(q, k, sm_scale), int(p_f32), stream,
        )
    _launch(status, _launch_name(impl, "fwd", q.dtype))
    return o, lse


def attention_dq(q, k, v, lse, delta, do, sm_scale: float, impl: str) -> torch.Tensor:
    """dq: ``attention_dq_kernel`` (bf16/f16) or ``tf32x3_dq_kernel``
    (f32) on CUDA, counted as ``{impl}_dq`` plus the dtype's suffix, the
    plain version on the CPU."""
    if not q.is_cuda:
        return attention_dq_plain(q, k, v, lse, delta, do, sm_scale)
    _check_inputs("dq", q, k, v, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry("dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _stat(lse, q).data_ptr(), _stat(delta, q).data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), *_dims(q, k, sm_scale), stream,
        )
    _launch(status, _launch_name(impl, "dq", q.dtype))
    return dq


def attention_dkv(q, k, v, lse, delta, do, sm_scale: float, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): ``attention_dkv_kernel`` (bf16/f16) or
    ``tf32x3_dkv_kernel`` (f32) on CUDA, counted as ``{impl}_dkv`` plus the
    dtype's suffix, the plain version on the CPU."""
    if not q.is_cuda:
        return attention_dkv_plain(q, k, v, lse, delta, do, sm_scale)
    _check_inputs("dkv", q, k, v, do)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry("dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _stat(lse, q).data_ptr(), _stat(delta, q).data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), *_dims(q, k, sm_scale), stream,
        )
    _launch(status, _launch_name(impl, "dkv", q.dtype))
    return dk, dv


def _stat(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A per-row statistic (lse, delta) as the kernels read it: f32
    [B, Hq, S] on q's device, contiguous (the dq kernels read each query
    row's value at its index) and 16-byte aligned (the dK/dV kernels load a
    tile's rows by TMA); a strided or misaligned one is copied."""
    shape = (q.shape[0], q.shape[2], q.shape[1])
    if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != q.device:
        raise ValueError(f"row statistics must be f32 {shape} on {q.device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# ---------------------------------------------------------------------------
# The kernels as operators of the dispatcher
# ---------------------------------------------------------------------------
# Selective remat (models/remat.py) chooses what to save by the operator that
# made a tensor, so the fused attention is a custom op, forward and backward,
# under the port's namespace: its CPU kernel is the plain version, its CUDA
# kernel the kernel wrapper (which launches or raises), dispatched on the
# device of its inputs; ``plain`` runs the plain version on either. The
# forward's (o, lse) are one output, so a policy that saves it keeps both.
OPS_NAMESPACE = "torchft_tpu_torch"


@torch.library.custom_op(f"{OPS_NAMESPACE}::attention_fwd", mutates_args=(), device_types="cpu")
def attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                     impl: str, plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention ("splash": P in f32; "flash": P
    rounded): the plain version on the CPU."""
    return _attention_fwd(q, k, v, sm_scale, impl, True)


@torch.library.custom_op(f"{OPS_NAMESPACE}::attention_bwd", mutates_args=(), device_types="cpu")
def attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                     lse: torch.Tensor, do: torch.Tensor, sm_scale: float, impl: str,
                     plain: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's o and lse and the output's gradient
    ``do``: the plain versions on the CPU."""
    return _attention_bwd(q, k, v, o, lse, do, sm_scale, impl, True)


def _attention_fwd(q, k, v, sm_scale: float, impl: str, plain: bool):
    if plain:
        o, lse = attention_fwd_plain(q, k, v, sm_scale, impl == "splash")
        return o.contiguous(), lse
    return attention_fwd(q, k, v, sm_scale, impl)


def _attention_bwd(q, k, v, o, lse, do, sm_scale: float, impl: str, plain: bool):
    delta = attention_delta(o, do)
    if plain:
        dq = attention_dq_plain(q, k, v, lse, delta, do, sm_scale)
        dk, dv = attention_dkv_plain(q, k, v, lse, delta, do, sm_scale)
    else:
        dq = attention_dq(q, k, v, lse, delta, do, sm_scale, impl)
        dk, dv = attention_dkv(q, k, v, lse, delta, do, sm_scale, impl)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


attention_fwd_op.register_kernel("cuda", _attention_fwd)
attention_bwd_op.register_kernel("cuda", _attention_bwd)


@attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, sm_scale, impl, plain):
    lse = q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, o, lse, do, sm_scale, impl, plain):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v))


def _attention_fwd_setup(ctx, inputs, output) -> None:
    q, k, v, sm_scale, impl, plain = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (sm_scale, impl, plain)


def _attention_fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = attention_bwd_op(q, k, v, o, lse, do.contiguous(), *ctx.args)
    return dq, dk, dv, None, None, None


attention_fwd_op.register_autograd(_attention_fwd_backward, setup_context=_attention_fwd_setup)


@torch.library.custom_op(f"{OPS_NAMESPACE}::attn_out", mutates_args=())
def attn_out(x: torch.Tensor) -> torch.Tensor:
    """The identity (a copy: an operator's output may not alias its input)
    on an attention output made of plain ops, so that selective remat can
    name it as it names the fused forward's: the counterpart of the
    reference's ``checkpoint_name(..., ATTN_OUT_NAME)``."""
    return x.clone()


@attn_out.register_fake
def _attn_out_fake(x):
    return torch.empty_like(x)


attn_out.register_autograd(lambda ctx, g: g)


def _fused(q, k, v, sm_scale: float, impl: str, plain: bool) -> torch.Tensor:
    return attention_fwd_op(q, k, v, sm_scale, impl, plain)[0]


@functools.lru_cache(maxsize=8)
def splash_scale(hd: int, dtype: torch.dtype) -> float:
    """K1's query scale: 1/sqrt(hd) rounded to the input dtype, as the
    reference's ``jnp.asarray(scale, q.dtype)``."""
    return float(torch.tensor(1.0 / math.sqrt(hd), dtype=dtype))


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K1: q pre-scaled in its own dtype, then the kernel with scale 1."""
    qs = q * splash_scale(q.shape[-1], q.dtype)
    return _fused(qs, k, v, 1.0, "splash", plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """K2: 1/sqrt(hd) applied to the f32 scores inside the kernel; GQA K/V
    read in place (the reference repeats them; dK/dV summed over the group
    is the transpose of that repeat)."""
    return _fused(q, k, v, 1.0 / math.sqrt(q.shape[-1]), "flash", plain)


def splash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 through the plain versions, forward and backward, on any device."""
    return splash_attention(q, k, v, plain=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2 through the plain versions, forward and backward, on any device."""
    return flash_attention(q, k, v, plain=True)


def resolve_impl(impl: Optional[str], q_shape, kv_heads: int, cuda: bool,
                 dtype: torch.dtype) -> str:
    """The implementation ``causal_attention`` runs for ``impl`` on a q of
    ``q_shape`` [B, S, Hq, hd] and ``dtype`` with ``kv_heads`` K/V heads,
    on a CUDA tensor or not. ``impl`` None reads ``ATTENTION_ENV`` now
    ("auto" if unset), and any value of it gives "xla" off the card.
    Raises ``ValueError`` for an unknown choice, and ``TypeError`` where a
    kernel would run on a CUDA tensor of a dtype no kernel takes (not in
    ``KERNEL_DTYPES``). Like the reference's rule, it has no other dtype
    clause."""
    if impl is None:
        impl = os.environ.get(ATTENTION_ENV, "auto")
        if impl not in IMPLS:
            raise ValueError(f"unknown {ATTENTION_ENV} value {impl!r}: expected one of {IMPLS}")
        if not cuda:
            return "xla"
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    S, hq, hd = q_shape[1], q_shape[2], q_shape[3]
    tileable = S % SEQ_TILE == 0 and hd in KERNEL_HEAD_DIMS
    if impl == "xla" or (cuda and not tileable) or (impl == "auto" and not cuda):
        return "xla"
    if cuda and dtype not in KERNEL_DTYPES:
        raise TypeError(f"the attention kernels take {_dtype_names()} tensors, got {dtype}: "
                        "cast the model, or pass impl='xla' for the materialized path")
    if impl == "auto":
        return "splash" if hq != kv_heads else "flash"
    return impl


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Dispatch to ``impl`` ("auto" | "xla" | "splash" | "flash"; None:
    ``TORCHFT_TPU_ATTENTION`` as read on this call) by ``resolve_impl``;
    an explicit "splash"/"flash" on a CPU tensor runs that kernel's plain
    version."""
    global LAST_DISPATCH
    LAST_DISPATCH = resolve_impl(impl, q.shape, k.shape[2], q.is_cuda, q.dtype)
    if LAST_DISPATCH == "xla":
        out = xla_attention(q, k, v, cfg)
        # only a recorded graph has a remat policy to name it for
        return attn_out(out) if torch.is_grad_enabled() else out
    if LAST_DISPATCH == "splash":
        return splash_attention(q, k, v)
    return flash_attention(q, k, v)
