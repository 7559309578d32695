"""fp8-quantized collectives: allreduce, reduce-scatter, and the
compressed-ring allreduce.

Counterpart of ``torchft_tpu/collectives.py``. ``allreduce_quantized``
quantizes to rowwise-scaled fp8, alltoalls so each rank owns one chunk,
dequantizes and reduces that chunk in f32, requantizes it, allgathers the
reduced chunks and dequantizes. ``reduce_scatter_quantized`` (``:702``)
stops after the reduce and returns this rank's f32 chunk. SUM and AVG only.
Two engines share one row-aligned chunk partition and one wire (uint8
codes, f32 row scales, element count), so a quorum may mix them:

- **device** (``:141-263``): a list of torch tensors on one device. The
  padded buffer is quantized in one launch (``fused_quantize_fp8``), the
  received chunks dequantized in one (``fused_dequantize_fp8``): the
  hand-written CUDA kernels on a CUDA device, their plain versions on the
  CPU. The sum over ranks is f32 on the device, in rank order. The wire
  depends on the process group's plane: a host process group gets the
  tuple wire, and only the ~1 byte/element fp8 payload crosses to the
  host; a device-native one (``device_native``, ``ProcessGroupDevice``)
  gets the packed device wire (``_pack_wire_device``, ``:172``: the codes'
  bytes, then the f32 scales' bytes, in one flat uint8 tensor on the
  device), so the exchange never leaves the device. Both wires carry the
  same codes, so both give the same sum bit for bit.
- **host** (``:558``, ``:685``): numpy inputs, the numpy codec, an f64
  accumulator, over a host process group only.

``allreduce_compressed`` (``:653``) codes host inputs into one
``CompressedWire`` (fp8 or int8) and hands it to ``pg.allreduce``: on
``ProcessGroupHost`` the compressed self-healing ring.

The pipeline runs on a worker thread and resolves a Work with the reduced
leaves (same shapes, dtypes and device as the inputs). Kernels launch on
that thread's current stream, which for a thread PyTorch did not set up is
the device's default stream, the one the caller's tensors were made on.
"""

from __future__ import annotations

import threading
from typing import Any, List, Sequence

import numpy as np
import torch

from torchft_tpu_torch.ops.quantization import (
    ROW,
    compress_bucket,
    decompress_bucket,
    dequantize_fp8_rowwise,
    fused_dequantize_fp8,
    fused_quantize_fp8,
    quantize_fp8_rowwise,
)
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.work import Future, FutureWork, Work

__all__ = ["allreduce_compressed", "allreduce_quantized", "reduce_scatter_quantized"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _run_async(fn) -> Work:
    fut: Future[Any] = Future()

    def runner():
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - resolves the Work
            try:
                fut.set_exception(e)
            except RuntimeError:
                pass

    threading.Thread(target=runner, daemon=True, name="torchft_quant_coll").start()
    return FutureWork(fut)


# ------------------------------------------------------------------- host
def _flatten_np(arrays: Sequence[np.ndarray]):
    hosts = [np.asarray(a) for a in arrays]
    flat = (
        np.concatenate([h.astype(np.float32).reshape(-1) for h in hosts])
        if hosts else np.zeros(0, np.float32)
    )
    return flat, [h.shape for h in hosts], [h.dtype for h in hosts]


def _unflatten_np(flat: np.ndarray, shapes, dtypes) -> List[np.ndarray]:
    out = []
    off = 0
    for shape, dtype in zip(shapes, dtypes):
        size = int(np.prod(shape)) if shape else 1
        out.append(flat[off:off + size].reshape(shape).astype(dtype))
        off += size
    return out


def _reduce_scatter_core(flat: np.ndarray, op: ReduceOp, pg: ProcessGroup):
    """The host engine's reduce-scatter: pad to whole rows per destination
    chunk, quantize each chunk, alltoall, sum in f64 (then AVG). Returns
    (this rank's reduced f32 chunk, chunk size)."""
    world = pg.size()
    chunk = max(1, _ceil_div(_ceil_div(flat.size, world), ROW)) * ROW
    padded = np.zeros(chunk * world, np.float32)
    padded[: flat.size] = flat
    sends = [
        quantize_fp8_rowwise(padded[r * chunk:(r + 1) * chunk])
        for r in range(world)
    ]
    recvd = pg.alltoall(sends).get_future().wait()
    acc = np.zeros(chunk, np.float64)
    for q, scales, n in recvd:
        acc[:n] += dequantize_fp8_rowwise(np.asarray(q), np.asarray(scales), n)
    if op == ReduceOp.AVG:
        acc /= world
    return acc.astype(np.float32), chunk


def _host_allreduce_pipeline(flat, shapes, dtypes, op, pg):
    world = pg.size()
    acc, chunk = _reduce_scatter_core(flat, op, pg)
    q, scales, n = quantize_fp8_rowwise(acc)
    gathered = pg.allgather([(q, scales, n)]).get_future().wait()
    out = np.zeros(chunk * world, np.float32)
    for r in range(world):
        qg, sg, ng = gathered[r][0]
        out[r * chunk:r * chunk + ng] = dequantize_fp8_rowwise(
            np.asarray(qg), np.asarray(sg), ng
        )
    return _unflatten_np(out[: flat.size], shapes, dtypes)


# ----------------------------------------------------------------- device
def _flatten_torch(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"device engine needs one device, got {sorted(map(str, devices))}")
    return torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])


def _unflatten_torch(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out = []
    off = 0
    for t in like:
        size = t.numel()
        out.append(flat[off:off + size].reshape(t.shape).to(t.dtype))
        off += size
    return out


def _wire_from_device(q: torch.Tensor, scales: torch.Tensor, n: int):
    """Device codes + scales -> host wire tuple (uint8 codes, f32 scales,
    n): the ~1 byte/element payload is the only device-to-host copy."""
    return (
        q.view(torch.uint8).cpu().numpy(),
        scales.reshape(-1).cpu().numpy(),
        n,
    )


def _device_from_wire(tuples: List[tuple], device: torch.device) -> torch.Tensor:
    """Stack same-shaped wires, dequantize them in ONE kernel launch, and
    return (world, chunk) f32 on ``device``."""
    world = len(tuples)
    qs = torch.from_numpy(np.stack([np.asarray(t[0]) for t in tuples]))
    ss = torch.from_numpy(np.stack([np.asarray(t[1]).reshape(-1) for t in tuples]))
    rows = qs.shape[1]
    qs = qs.to(device).view(torch.float8_e4m3fn).reshape(world * rows, ROW)
    ss = ss.to(device).reshape(world * rows, 1)
    deq = fused_dequantize_fp8(qs, ss, world * rows * ROW)
    return deq.reshape(world, rows * ROW)


def _sum_ranks(deq: torch.Tensor) -> torch.Tensor:
    """f32 sum over the world axis in rank order: ((r0 + r1) + r2) + ..."""
    acc = deq[0].clone()
    for r in range(1, deq.shape[0]):
        acc += deq[r]
    return acc


def _pack_wire_device(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(rows, ROW) fp8 codes + (rows, 1) f32 scales -> ONE flat uint8
    tensor on their device: the codes' bytes, then the scales' bytes
    (little-endian, as the reference's bitcast). A device-native process
    group moves it without leaving the device."""
    return torch.cat([
        q.reshape(-1).view(torch.uint8),
        scales.to(torch.float32).reshape(-1).view(torch.uint8),
    ])


def _unpack_dequant_device(bufs: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """Inverse of ``_pack_wire_device`` over same-shaped wires: ONE
    dequantize launch over all of them; (len(bufs), rows * ROW) f32."""
    world = len(bufs)
    codes = rows * ROW
    q = torch.cat([b[:codes] for b in bufs]).view(torch.float8_e4m3fn).reshape(world * rows, ROW)
    s = torch.cat([b[codes:] for b in bufs]).view(torch.float32).reshape(world * rows, 1)
    return fused_dequantize_fp8(q, s, world * codes).reshape(world, codes)


def _device_pg(pg: ProcessGroup) -> bool:
    return bool(getattr(pg, "device_native", False))


def _reduce_scatter_core_device(flat: torch.Tensor, op: ReduceOp, pg: ProcessGroup):
    """The device engine's reduce-scatter: one quantize launch over the
    buffer padded to whole rows per destination chunk, the chunks' wires
    (packed on the device for a device-native group, else the host tuple
    wire), alltoall, one dequantize launch over the received chunks, the
    f32 sum in rank order (then AVG). Returns (this rank's reduced f32
    chunk on ``flat``'s device, rows per chunk)."""
    world = pg.size()
    chunk_rows = max(1, _ceil_div(_ceil_div(flat.numel(), world), ROW))
    chunk = chunk_rows * ROW
    # the kernel zero-fills the rows past the data: no padded copy
    q, scales, _ = fused_quantize_fp8(flat, rows=world * chunk_rows)
    parts = [(q[r * chunk_rows:(r + 1) * chunk_rows], scales[r * chunk_rows:(r + 1) * chunk_rows])
             for r in range(world)]
    if _device_pg(pg):
        sends: List[Any] = [_pack_wire_device(qr, sr) for qr, sr in parts]
    else:
        sends = [_wire_from_device(qr, sr, chunk) for qr, sr in parts]
    del q, scales, parts
    recvd = list(pg.alltoall(sends).get_future().wait())
    del sends
    if _device_pg(pg):
        deq = _unpack_dequant_device(recvd, chunk_rows)
    else:
        deq = _device_from_wire(recvd, flat.device)
    del recvd
    acc = _sum_ranks(deq)
    if op == ReduceOp.AVG:
        acc = acc / world
    return acc, chunk_rows


def _allreduce_quantized_device(flat, like, op, pg):
    world = pg.size()
    acc, chunk_rows = _reduce_scatter_core_device(flat, op, pg)
    chunk = chunk_rows * ROW
    q, scales, _ = fused_quantize_fp8(acc)
    del acc
    if _device_pg(pg):
        gathered = pg.allgather([_pack_wire_device(q, scales)]).get_future().wait()
        deq = _unpack_dequant_device([g[0] for g in gathered], chunk_rows)
    else:
        gathered = pg.allgather([_wire_from_device(q, scales, chunk)]).get_future().wait()
        deq = _device_from_wire([g[0] for g in gathered], flat.device)
    return _unflatten_torch(deq.reshape(world * chunk)[: flat.numel()], like)


def _check_host_engine(pg: ProcessGroup) -> None:
    if _device_pg(pg):
        raise TypeError("a device-native process group takes torch tensors: the host engine's "
                        "numpy wire rides a host process group")


def allreduce_quantized(arrays: Sequence[Any], op: ReduceOp, pg: ProcessGroup) -> Work:
    """fp8-compressed allreduce over ``pg``. Returns a Work resolving to
    the reduced arrays (same shapes and dtypes as the inputs; tensors on
    the inputs' device)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"allreduce_quantized supports SUM/AVG, got {op}")

    if arrays and all(isinstance(a, torch.Tensor) for a in arrays):
        like = list(arrays)
        flat = _flatten_torch(like)

        def run_device() -> List[torch.Tensor]:
            if pg.size() <= 1:
                return _unflatten_torch(flat, like)
            return _allreduce_quantized_device(flat, like, op, pg)

        return _run_async(run_device)

    _check_host_engine(pg)
    flat, shapes, dtypes = _flatten_np(arrays)

    def run() -> List[np.ndarray]:
        if pg.size() <= 1:
            out = flat if op == ReduceOp.SUM else flat.copy()
            return _unflatten_np(out, shapes, dtypes)
        return _host_allreduce_pipeline(flat, shapes, dtypes, op, pg)

    return _run_async(run)


def reduce_scatter_quantized(arrays: Sequence[Any], op: ReduceOp, pg: ProcessGroup) -> Work:
    """fp8-compressed reduce-scatter over ``pg``: a Work resolving to this
    rank's reduced f32 chunk of the concatenated inputs (rank r owns the
    padded elements ``[r * chunk, (r + 1) * chunk)``, chunk a whole number
    of 512-wide rows). Torch tensors on one device run the device engine
    and get the chunk on that device (on CUDA: one quantize and one
    dequantize launch; a failed build or launch fails the Work); numpy
    inputs run the host engine and get an ndarray."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter_quantized supports SUM/AVG, got {op}")

    if arrays and all(isinstance(a, torch.Tensor) for a in arrays):
        leaves = list(arrays)

        def run_device() -> torch.Tensor:
            # flattened on the worker: leaves on two devices fail the Work
            flat = _flatten_torch(leaves)
            if pg.size() <= 1:
                return flat
            acc, _rows = _reduce_scatter_core_device(flat, op, pg)
            return acc

        return _run_async(run_device)

    _check_host_engine(pg)
    flat, _, _ = _flatten_np(arrays)

    def run() -> np.ndarray:
        if pg.size() <= 1:
            return flat.copy()
        acc, _chunk = _reduce_scatter_core(flat, op, pg)
        return acc

    return _run_async(run)


def allreduce_compressed(
    arrays: Sequence[Any], op: ReduceOp, pg: ProcessGroup, mode: str = "fp8"
) -> Work:
    """Compressed allreduce through the process group's ring: the inputs
    (host arrays) are coded into ONE ``CompressedWire`` (``mode`` "fp8" or
    "int8") that goes straight into ``pg.allreduce``, which on
    ``ProcessGroupHost`` is the compressed self-healing ring (dequantize,
    sum in f32 and requantize at each hop; re-routes around a dead link).
    The Manager's streamed buckets ride the same wire; this is the direct
    entry. Resolves to ndarrays of the inputs' shapes and dtypes."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"allreduce_compressed supports SUM/AVG, got {op}")
    flat, shapes, dtypes = _flatten_np(arrays)
    wire = compress_bucket(flat, mode)

    def run() -> List[np.ndarray]:
        if pg.size() <= 1:
            return _unflatten_np(flat.copy(), shapes, dtypes)
        out = pg.allreduce([wire], op).get_future().wait()
        return _unflatten_np(decompress_bucket(out[0]).numpy(), shapes, dtypes)

    return _run_async(run)
