"""Rowwise-scaled fp8 quantization for the quantized allreduce.

Counterpart of ``torchft_tpu/ops/quantization.py``. Values are viewed as
rows of ``ROW`` (512, the reference's default and the only row length the
port uses) elements, zero-padded; each row gets one f32 scale
and e4m3fn codes. Three implementations of one wire format:

- the numpy **host codec** (``quantize_fp8_rowwise`` /
  ``dequantize_fp8_rowwise``), a copy of the reference's (``:57-243``) with
  the fp8 cast done by torch instead of ml_dtypes;
- ``fused_quantize_fp8`` / ``fused_dequantize_fp8``, the **device** path:
  on a CUDA tensor they launch the hand-written kernels of
  ``csrc/fp8_rowwise.cu`` (replacing the reference's Pallas
  ``_quantize_kernel`` / ``_dequantize_kernel``) and count each launch in
  ``LAUNCHES``; on a CPU tensor they run the plain version below. A failed
  build or launch raises: there is no fallback for CUDA tensors;
- ``quantize_fp8_plain`` / ``dequantize_fp8_plain``, the plain torch
  version of the kernels' arithmetic, used by the tests and on CPU tensors.

Device-path numerics (equal, bit for bit, to the reference kernel on the
CPU for finite input): scale = amax * f32(1/448) when amax > 0 else 1 (XLA
rewrites the reference's ``amax / 448`` into this reciprocal multiply),
codes = x / scale rounded to nearest even. A quotient above 464 in
magnitude, or NaN, becomes the NaN code 0x7f | sign, as ml_dtypes and XLA
convert (torch's own cast would saturate to 448). All-subnormal rows follow
IEEE here; XLA's CPU backend flushes them to a zero row.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

FP8_MAX = 448.0  # float8_e4m3fn max normal value
ROW = 512  # row length of the wire; the CUDA kernels are built for it
# above this magnitude a value rounds past FP8_MAX: NaN in e4m3fn
_FP8_OVERFLOW = 464.0

__all__ = [
    "quantize_fp8_rowwise",
    "dequantize_fp8_rowwise",
    "fused_quantize_fp8",
    "fused_dequantize_fp8",
    "quantize_fp8_plain",
    "dequantize_fp8_plain",
    "LAUNCHES",
    "reset_launches",
]

# kernel launches per wrapper, counted only where the kernel is launched
LAUNCHES: Dict[str, int] = {"quantize_fp8_rowwise": 0, "dequantize_fp8_rowwise": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _to_e4m3fn(v: torch.Tensor) -> torch.Tensor:
    """f32 -> e4m3fn codes with the reference's overflow rule (NaN, sign
    kept) in place of torch's saturation to 448."""
    over = v.abs() > _FP8_OVERFLOW
    v = torch.where(over, torch.copysign(torch.full_like(v, float("nan")), v), v)
    return v.to(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# Host (numpy) codec — the wire of the host engine
# ---------------------------------------------------------------------------
def _pad_rows(flat: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """View ``flat`` as a (rows, ROW) f32 matrix, zero-padding the tail."""
    flat = np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)
    n = flat.size
    rows = max(1, -(-n // ROW))
    if n == rows * ROW:
        return flat.reshape(rows, ROW), rows, n
    padded = np.zeros(rows * ROW, dtype=np.float32)
    padded[:n] = flat
    return padded.reshape(rows, ROW), rows, n


@functools.lru_cache(maxsize=1)
def _fp8_dequant_lut() -> np.ndarray:
    """All 256 e4m3fn values as f32, indexed by bit pattern."""
    return (
        torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
        .to(torch.float32).numpy()
    )


def quantize_fp8_rowwise(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quantize a flat f32 array to (uint8 codes [rows,ROW], f32 scales
    [rows], n) exactly as the reference's host codec does (scale = amax/448,
    codes = x * (1/scale))."""
    mat, _rows, n = _pad_rows(flat)
    amax = np.max(np.abs(mat), axis=1, keepdims=True)
    scales = np.where(amax > 0, amax / FP8_MAX, 1.0).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        scaled = mat * (np.float32(1.0) / scales)
    q = _to_e4m3fn(torch.from_numpy(scaled)).view(torch.uint8).numpy()
    return q, scales[:, 0], n


def dequantize_fp8_rowwise(
    payload: np.ndarray, scales: np.ndarray, n: int, dtype=np.float32
) -> np.ndarray:
    """Inverse of quantize_fp8_rowwise; a flat array of length n."""
    scales = np.asarray(scales).reshape(-1)
    mat = _fp8_dequant_lut()[payload.reshape(scales.size, -1)]
    mat *= scales[:, None]
    out = mat.reshape(-1)[:n]
    return out if dtype == np.float32 else out.astype(dtype)


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels' arithmetic
# ---------------------------------------------------------------------------
def quantize_fp8_plain(
    x: torch.Tensor, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(e4m3fn codes [rows,ROW], f32 scales [rows,1], n) of flat ``x``.
    ``rows`` (default ceil(n/ROW), at least 1) may exceed the data: the
    extra rows quantize zeros."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    rows = _rows_for(n, rows)
    mat = torch.zeros(rows * ROW, dtype=torch.float32, device=flat.device)
    mat[:n] = flat
    mat = mat.view(rows, ROW)
    amax = mat.abs().amax(dim=1, keepdim=True)
    recip = torch.tensor(1.0 / FP8_MAX, dtype=torch.float32, device=mat.device)
    scales = torch.where(amax > 0, amax * recip, torch.ones_like(amax))
    return _to_e4m3fn(mat / scales), scales, n


def dequantize_fp8_plain(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """codes × row scale -> flat f32, truncated to n."""
    out = q.to(torch.float32) * scales.reshape(-1, 1).to(torch.float32)
    return out.reshape(-1)[:n]


def _rows_for(n: int, rows: Optional[int]) -> int:
    need = max(1, -(-n // ROW))
    if rows is None:
        return need
    if rows < need:
        raise ValueError(f"rows={rows} cannot hold {n} values in rows of {ROW}")
    return rows


# ---------------------------------------------------------------------------
# Device path: the CUDA kernels (plain version for CPU tensors)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _kernels() -> ctypes.CDLL:
    from torchft_tpu_torch.ops._build import load_library

    lib = load_library("fp8_rowwise.cu")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tft_quantize_fp8_rowwise.argtypes = [vp, i64, i64, ci, vp, vp, vp]
    lib.tft_quantize_fp8_rowwise.restype = ci
    lib.tft_dequantize_fp8_rowwise.argtypes = [vp, vp, i64, ci, vp, vp]
    lib.tft_dequantize_fp8_rowwise.restype = ci
    lib.tft_fp8_row.restype = ci
    if lib.tft_fp8_row() != ROW:
        raise RuntimeError("fp8 kernel library was built for another row length")
    return lib


def _check_launch(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")


def fused_quantize_fp8(
    x: torch.Tensor, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Quantize a tensor to (e4m3fn [rows,ROW], f32 scales [rows,1], n).

    On CUDA: one launch of ``quantize_fp8_rowwise_kernel`` on the current
    stream over the flat f32 view of ``x`` (a non-f32 input is cast first);
    the kernel zero-fills the ragged tail and any ``rows`` past the data.
    On CPU: the plain version."""
    if not x.is_cuda:
        return quantize_fp8_plain(x, rows)
    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    flat = flat.contiguous()
    n = flat.numel()
    rows = _rows_for(n, rows)
    q = torch.empty((rows, ROW), dtype=torch.float8_e4m3fn, device=flat.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = _kernels().tft_quantize_fp8_rowwise(
            flat.data_ptr(), n, rows, int(flat.data_ptr() % 16 == 0),
            q.data_ptr(), scales.data_ptr(), stream,
        )
    _check_launch(status, "quantize_fp8_rowwise_kernel")
    _count("quantize_fp8_rowwise")
    return q, scales, n


def fused_dequantize_fp8(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of fused_quantize_fp8: flat f32 of length ``n``.

    On CUDA: one launch of ``dequantize_fp8_rowwise_kernel`` on the current
    stream. On CPU: the plain version."""
    if not q.is_cuda:
        return dequantize_fp8_plain(q, scales, n)
    if q.dim() != 2 or q.shape[1] != ROW:
        raise ValueError(f"the CUDA fp8 kernel takes codes of shape [rows, {ROW}]")
    if q.dtype not in (torch.float8_e4m3fn, torch.uint8):
        raise TypeError(f"codes must be float8_e4m3fn or uint8, got {q.dtype}")
    if scales.dtype != torch.float32 or scales.numel() != q.shape[0]:
        raise ValueError("scales must be f32 with one value per row")
    if not (scales.device == q.device and q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous on one device")
    if not 0 <= n <= q.numel():
        raise ValueError(f"n={n} outside the {q.numel()} codes")
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernels().tft_dequantize_fp8_rowwise(
            q.data_ptr(), scales.data_ptr(), n, int(q.data_ptr() % 4 == 0),
            out.data_ptr(), stream,
        )
    _check_launch(status, "dequantize_fp8_rowwise_kernel")
    _count("dequantize_fp8_rowwise")
    return out
