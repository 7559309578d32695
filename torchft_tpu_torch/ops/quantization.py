"""Rowwise-scaled quantization for the quantized allreduce and the
compressed wire of the streamed buckets.

Counterpart of ``torchft_tpu/ops/quantization.py``. Values are viewed as
rows of ``ROW`` (512, the reference's default and the only row length the
CUDA kernels take) elements, zero-padded; each row gets one f32 scale and
e4m3fn (or int8) codes. The implementations:

- the numpy **host codecs** (``quantize_fp8_rowwise`` /
  ``dequantize_fp8_rowwise``, ``quantize_int8_rowwise`` /
  ``dequantize_int8_rowwise``), copies of the reference's (``:57-165``)
  with the fp8 cast done by torch instead of ml_dtypes;
- ``fused_quantize_fp8`` / ``fused_dequantize_fp8``, the **device** path
  of the serial quantized allreduce: on a CUDA tensor they launch the
  hand-written kernels of ``csrc/fp8_rowwise.cu`` (replacing the
  reference's Pallas ``_quantize_kernel`` / ``_dequantize_kernel``) and
  count each launch in ``LAUNCHES``; on a CPU tensor they run the plain
  version below. A failed build or launch raises: there is no fallback for
  CUDA tensors;
- ``fused_quantize_fp8_host``, the second instance of the quantize kernel,
  with the HOST codec's rule: a bucket of the streamed allreduce that lies
  on the card is quantized there to the same codes and scales, bit for
  bit, as the reference's numpy ``compress_bucket`` gives it on the host;
- ``quantize_fp8_plain`` / ``quantize_fp8_host_plain`` /
  ``dequantize_fp8_plain``, the plain torch versions of the kernels'
  arithmetic, used by the tests and on CPU tensors;
- the compressed-wire surface of the streamed buckets (``:167-243``):
  ``CompressedWire``, ``codec``, ``resolve_compress_mode``,
  ``compress_bucket`` and ``decompress_bucket``. A CUDA bucket in fp8 is
  coded on the card (``fused_quantize_fp8_host``, ``fused_dequantize_fp8``)
  and only its codes and scales cross to the host.

Serial-engine numerics (equal, bit for bit, to the reference kernel on the
CPU for finite input): scale = amax * f32(1/448) when amax > 0 else 1 (XLA
rewrites the reference's ``amax / 448`` into this reciprocal multiply),
codes = x / scale rounded to nearest even. Host-codec numerics: scale =
amax / 448 (IEEE divide), codes = x * (1 / scale). Both: a value above 464
in magnitude, or NaN, becomes the NaN code 0x7f | sign, as ml_dtypes and
XLA convert (torch's own cast would saturate to 448). All-subnormal rows
follow IEEE here; XLA's CPU backend flushes them to a zero row.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch import knobs

FP8_MAX = 448.0  # float8_e4m3fn max normal value
INT8_MAX = 127.0
ROW = 512  # row length of the wire; the CUDA kernels are built for it
# above this magnitude a value rounds past FP8_MAX: NaN in e4m3fn
_FP8_OVERFLOW = 464.0

COMPRESS_ENV = "TORCHFT_COMPRESS"
COMPRESS_MODES = ("off", "fp8", "int8")

__all__ = [
    "quantize_fp8_rowwise",
    "dequantize_fp8_rowwise",
    "fused_quantize_fp8",
    "fused_dequantize_fp8",
    "fused_quantize_fp8_host",
    "quantize_fp8_plain",
    "quantize_fp8_host_plain",
    "dequantize_fp8_plain",
    "quantize_int8_rowwise",
    "dequantize_int8_rowwise",
    "CompressedWire",
    "is_compressed_wire",
    "codec",
    "resolve_compress_mode",
    "compress_bucket",
    "decompress_bucket",
    "COMPRESS_ENV",
    "COMPRESS_MODES",
    "LAUNCHES",
    "reset_launches",
]

# kernel launches per wrapper, counted only where the kernel is launched
LAUNCHES: Dict[str, int] = {
    "quantize_fp8_rowwise": 0,
    "dequantize_fp8_rowwise": 0,
    "quantize_fp8_rowwise_host": 0,
}
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
def _pad_rows(flat: np.ndarray, row: int = ROW) -> Tuple[np.ndarray, int, int]:
    """View ``flat`` as a (rows, row) f32 matrix, zero-padding the tail."""
    flat = np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)
    n = flat.size
    rows = max(1, -(-n // row))
    if n == rows * row:
        return flat.reshape(rows, row), rows, n
    padded = np.zeros(rows * row, dtype=np.float32)
    padded[:n] = flat
    return padded.reshape(rows, row), rows, n


@functools.lru_cache(maxsize=1)
def _fp8_dequant_lut() -> np.ndarray:
    """All 256 e4m3fn values as f32, indexed by bit pattern."""
    return (
        torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
        .to(torch.float32).numpy()
    )


def quantize_fp8_rowwise(
    flat: np.ndarray, row: int = ROW
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quantize a flat f32 array to (uint8 codes [rows,row], f32 scales
    [rows], n) as the reference's host codec does (scale = amax/448, codes
    = x * (1/scale)), but a row whose scale has no finite reciprocal: it
    is coded as a zero row (scale 1, codes +-0), where the reference codes
    it all NaN (``_finite_reciprocals``)."""
    mat, _rows, n = _pad_rows(flat, row)
    amax = np.max(np.abs(mat), axis=1, keepdims=True)
    scales, inv = _finite_reciprocals(
        np.where(amax > 0, amax / FP8_MAX, 1.0).astype(np.float32))
    with np.errstate(over="ignore", invalid="ignore"):
        scaled = mat * inv
    q = _to_e4m3fn(torch.from_numpy(scaled)).view(torch.uint8).numpy()
    return q, scales[:, 0], n


def _finite_reciprocals(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(scales, 1 / scales)`` with every row whose reciprocal overflows
    (a scale under 2^-128: each of its values under the code range's top
    times 2^-128) set to scale 1. Error feedback drives a row there: the
    residual of a row that stops receiving gradient shrinks by the code's
    rounding each step, and x * (1/scale) = x * inf would code the whole
    row NaN (the reference's codec does, ~20 steps on). Scale 1 codes its
    values to +-0 and leaves them in the residual."""
    with np.errstate(divide="ignore", over="ignore"):
        inv = np.float32(1.0) / scales
    tiny = np.isinf(inv)
    if tiny.any():
        scales = np.where(tiny, np.float32(1.0), scales)
        inv = np.where(tiny, np.float32(1.0), inv)
    return scales, inv


def dequantize_fp8_rowwise(
    payload: np.ndarray, scales: np.ndarray, n: int, dtype=np.float32
) -> np.ndarray:
    """Inverse of quantize_fp8_rowwise; a flat array of length n."""
    scales = np.asarray(scales).reshape(-1)
    mat = _fp8_dequant_lut()[payload.reshape(scales.size, -1)]
    mat *= scales[:, None]
    out = mat.reshape(-1)[:n]
    return out if dtype == np.float32 else out.astype(dtype)


def quantize_int8_rowwise(
    flat: np.ndarray, row: int = ROW
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Symmetric rowwise int8: (int8 codes viewed uint8, f32 scales
    [rows], n), scale = amax/127. A non-finite value saturates at the
    row's largest finite magnitude (NaN becomes 0), as in the reference."""
    mat, _rows, n = _pad_rows(flat, row)
    amax = np.max(np.abs(mat), axis=1, keepdims=True)
    all_finite = bool(np.isfinite(amax).all())
    finite_amax = (
        amax if all_finite
        else np.where(np.isfinite(amax), amax, np.float32(0.0))
    )
    scales = np.where(finite_amax > 0, finite_amax / INT8_MAX, 1.0).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        q = mat * (np.float32(1.0) / scales)
    np.rint(q, out=q)
    np.clip(q, -INT8_MAX, INT8_MAX, out=q)
    if not all_finite:
        q = np.nan_to_num(q, nan=0.0, posinf=INT8_MAX, neginf=-INT8_MAX)
    return q.astype(np.int8).view(np.uint8), scales[:, 0], n


def dequantize_int8_rowwise(
    payload: np.ndarray, scales: np.ndarray, n: int, dtype=np.float32
) -> np.ndarray:
    """Inverse of quantize_int8_rowwise; a flat array of length n."""
    scales = np.asarray(scales).reshape(-1)
    mat = payload.view(np.int8).reshape(scales.size, -1).astype(np.float32)
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


def quantize_fp8_host_plain(
    x: torch.Tensor, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The host codec's rule in torch: (e4m3fn codes [rows,ROW], f32 scales
    [rows,1], n) with scale = amax / 448 and codes = x * (1 / scale), each
    step one IEEE f32 operation as numpy takes it; a row whose scale has
    no finite reciprocal is a zero row (``_finite_reciprocals``)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    rows = _rows_for(n, rows)
    mat = torch.zeros(rows * ROW, dtype=torch.float32, device=flat.device)
    mat[:n] = flat
    mat = mat.view(rows, ROW)
    amax = mat.abs().amax(dim=1, keepdim=True)
    one = torch.ones_like(amax)
    scales = torch.where(amax > 0, amax / torch.full_like(amax, FP8_MAX), one)
    inv = one / scales
    tiny = torch.isinf(inv)
    scales = torch.where(tiny, one, scales)
    prod = mat * torch.where(tiny, one, inv)
    # NaNs as numpy makes them on an x86 host: a NaN input keeps its sign,
    # an invalid product (inf * 0) is the negative default NaN; CUDA's
    # multiply gives a positive NaN for both
    neg_nan = torch.tensor(-0x400000, dtype=torch.int32, device=prod.device).view(torch.float32)
    prod = torch.where(torch.isnan(mat), mat, torch.where(torch.isnan(prod), neg_nan, prod))
    return _to_e4m3fn(prod), scales, n


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
    for fn in (lib.tft_quantize_fp8_rowwise, lib.tft_quantize_fp8_rowwise_host):
        fn.argtypes = [vp, i64, i64, ci, vp, vp, vp]
        fn.restype = ci
    lib.tft_dequantize_fp8_rowwise.argtypes = [vp, vp, i64, ci, vp, vp]
    lib.tft_dequantize_fp8_rowwise.restype = ci
    lib.tft_fp8_row.restype = ci
    if lib.tft_fp8_row() != ROW:
        raise RuntimeError("fp8 kernel library was built for another row length")
    return lib


def _check_launch(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")


def _launch_quantize(
    x: torch.Tensor, rows: Optional[int], entry: str, name: str
) -> Tuple[torch.Tensor, torch.Tensor, int]:
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
        status = getattr(_kernels(), entry)(
            flat.data_ptr(), n, rows, int(flat.data_ptr() % 16 == 0),
            q.data_ptr(), scales.data_ptr(), stream,
        )
    _check_launch(status, "quantize_fp8_rowwise_kernel")
    _count(name)
    return q, scales, n


def fused_quantize_fp8(
    x: torch.Tensor, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Quantize a tensor to (e4m3fn [rows,ROW], f32 scales [rows,1], n).

    On CUDA: one launch of ``quantize_fp8_rowwise_kernel<false>`` (the
    reference kernel's rule) on the current stream over the flat f32 view
    of ``x`` (a non-f32 input is cast first); the kernel zero-fills the
    ragged tail and any ``rows`` past the data. On CPU: the plain
    version."""
    if not x.is_cuda:
        return quantize_fp8_plain(x, rows)
    return _launch_quantize(x, rows, "tft_quantize_fp8_rowwise", "quantize_fp8_rowwise")


def fused_quantize_fp8_host(
    x: torch.Tensor, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``fused_quantize_fp8`` with the host codec's rule (scale = amax /
    448, codes = x * (1 / scale)): the codes and scales the reference's
    ``compress_bucket`` gives the same values, bit for bit.

    On CUDA: one launch of ``quantize_fp8_rowwise_kernel<true>``, counted
    under ``quantize_fp8_rowwise_host``. On CPU: the plain version."""
    if not x.is_cuda:
        return quantize_fp8_host_plain(x, rows)
    return _launch_quantize(
        x, rows, "tft_quantize_fp8_rowwise_host", "quantize_fp8_rowwise_host"
    )


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


# ---------------------------------------------------------------------------
# Compressed-wire surface: the per-bucket codec of the streamed allreduce
# and of the host compressed ring (process_group._ring_allreduce_compressed)
# ---------------------------------------------------------------------------
class CompressedWire(NamedTuple):
    """One bucket's compressed payload as it rides the host wire.

    A NamedTuple, so the process group's staging passes it through
    untouched. ``payload`` and ``scales`` are host arrays: they are the
    bytes on the socket. ``device`` never goes on the socket: it names the
    card a bucket was coded on (None: the host), where the ring's hops and
    the landing decode and recode it."""

    mode: str  # "fp8" | "int8"
    payload: np.ndarray  # (rows, row) uint8 bit patterns of the codes
    scales: np.ndarray  # (rows,) f32 rowwise scales
    n: int  # unpadded element count
    dtype: str  # the bucket's dtype name, restored on decompress
    row: int  # row length the scales are keyed to
    device: Optional[str] = None


def is_compressed_wire(x: Any) -> bool:
    return isinstance(x, CompressedWire)


def codec(mode: str):
    """(quantize, dequantize) host pair of a compress mode."""
    if mode == "fp8":
        return quantize_fp8_rowwise, dequantize_fp8_rowwise
    if mode == "int8":
        return quantize_int8_rowwise, dequantize_int8_rowwise
    raise ValueError(f"no codec for compress mode {mode!r}")


def resolve_compress_mode(mode: Optional[str] = None) -> str:
    """The wire-compression mode: ``TORCHFT_COMPRESS`` > ``mode`` > "off".

    Read through ``knobs.env_raw``, so an override of the knob wins over
    the environment. Raises ValueError on a value outside ``COMPRESS_MODES``."""
    raw = knobs.env_raw(COMPRESS_ENV)
    if raw is not None:
        value = raw.strip().lower() or "off"
    elif mode is not None:
        value = str(mode).strip().lower() or "off"
    else:
        value = "off"
    if value not in COMPRESS_MODES:
        raise ValueError(
            f"invalid compress mode {value!r} (from {COMPRESS_ENV} or "
            f"constructor): expected one of {COMPRESS_MODES}"
        )
    return value


def dtype_name(dtype: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ... for a torch or numpy dtype (the
    reference's ``np.dtype(...).name``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype) if isinstance(dtype, str) else np.dtype(dtype).name


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


def on_card(wire: CompressedWire) -> Optional[torch.device]:
    """The CUDA device whose kernels decode and recode ``wire``, or None
    when its arithmetic runs in the host codec."""
    if wire.device is None or wire.mode != "fp8":
        return None
    dev = torch.device(wire.device)
    return dev if dev.type == "cuda" else None


def _host_f32(flat: Any) -> np.ndarray:
    if isinstance(flat, torch.Tensor):
        flat = flat.detach().reshape(-1).to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)


def host_empty(shape: Tuple[int, ...], dtype: torch.dtype, pinned: bool) -> np.ndarray:
    """An uninitialized host array, in page-locked memory when ``pinned``
    (the array keeps it alive): copies between it and the card run at the
    link's rate, several times those of pageable memory."""
    return torch.empty(shape, dtype=dtype, pin_memory=pinned).numpy()


def _to_pinned(t: torch.Tensor) -> np.ndarray:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def encode_fp8_on_card(x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, int]:
    """The host codec's (uint8 codes [rows,ROW], f32 scales [rows], n) of a
    CUDA tensor, computed on the card (``fused_quantize_fp8_host``); only
    the codes and scales are copied to the host, into page-locked memory."""
    q, s, n = fused_quantize_fp8_host(x)
    return _to_pinned(q.view(torch.uint8)), _to_pinned(s.reshape(-1)), n


def decode_fp8_on_card(
    payload: np.ndarray, scales: np.ndarray, n: int, device: torch.device
) -> torch.Tensor:
    """f32[n] on ``device`` of host codes and scales: one copy to the card,
    one ``fused_dequantize_fp8`` launch."""
    q = torch.from_numpy(np.ascontiguousarray(payload)).to(device).reshape(-1, ROW)
    s = torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)).to(device)
    return fused_dequantize_fp8(q, s.reshape(-1, 1), n)


def compress_bucket(
    flat: Any,
    mode: str,
    row: int = ROW,
    dtype: Any = None,
    residual: Optional[torch.Tensor] = None,
) -> CompressedWire:
    """Quantize one flat bucket (a tensor or an array) into a
    CompressedWire whose ``dtype`` is ``dtype`` (default: the bucket's).

    A CUDA tensor in fp8 is coded on the card by the host-rule kernel and
    only its codes and scales are copied to the host; anything else goes
    through the host codec. ``residual`` (f32, ``flat``'s size) receives
    ``flat - decompress(wire)`` in f32, computed where the codes were made:
    the error-feedback update of the streamed allreduce."""
    out_dtype = dtype_name(dtype if dtype is not None else flat.dtype)
    if isinstance(flat, torch.Tensor) and flat.is_cuda and mode == "fp8":
        if row != ROW:
            raise ValueError(f"the CUDA fp8 kernels take rows of {ROW}, not {row}")
        work = flat.detach().reshape(-1).to(torch.float32)
        q, s, n = fused_quantize_fp8_host(work)
        if residual is not None:
            torch.sub(work, fused_dequantize_fp8(q, s, n), out=residual.view(-1))
        return CompressedWire(
            mode, _to_pinned(q.view(torch.uint8)), _to_pinned(s.reshape(-1)), n,
            out_dtype, row, str(flat.device),
        )
    quantize, dequantize = codec(mode)
    host = _host_f32(flat)
    payload, scales, n = quantize(host, row=row)
    if residual is not None:
        deq = dequantize(payload, scales, n, np.float32)
        if residual.is_cuda:
            residual.view(-1).copy_(torch.from_numpy(np.subtract(host, deq)))
        else:
            np.subtract(host, deq, out=residual.view(-1).numpy())
    device = str(flat.device) if isinstance(flat, torch.Tensor) else None
    return CompressedWire(mode, payload, scales, n, out_dtype, row, device)


def decompress_bucket(wire: CompressedWire, dtype: Any = None) -> torch.Tensor:
    """Inverse of compress_bucket: a flat tensor of ``wire.n`` values in
    ``dtype`` (default: the wire's), on the card that coded it (decoded
    there by ``fused_dequantize_fp8``) or on the CPU (host codec). The f32
    values are rounded once to the dtype, as the reference's ``astype``."""
    out_dtype = torch_dtype(dtype if dtype is not None else wire.dtype)
    dev = on_card(wire)
    if dev is not None:
        flat = decode_fp8_on_card(wire.payload, wire.scales, wire.n, dev)
    else:
        _, dequantize = codec(wire.mode)
        flat = torch.from_numpy(dequantize(wire.payload, wire.scales, wire.n, np.float32))
    return flat if out_dtype == torch.float32 else flat.to(out_dtype)
