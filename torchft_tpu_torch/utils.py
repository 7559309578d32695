"""Device resolution shared by the port's entry points, the divide the
landings of the allreduce share, the digest the entry points print, and
the local shard of a possibly distributed tensor."""

from __future__ import annotations

import hashlib
from typing import Any, Iterable, Optional, Union

import torch

__all__ = ["local_shard", "resolve_device", "tensors_sha256", "true_divide"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (explicitly or by default)
    and is not available, so a run never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def true_divide(x: Any, n: int) -> Any:
    """``x / n`` in ``x``'s dtype, each value rounded once from the f32 (or
    wider) quotient as numpy and ml_dtypes divide. PyTorch divides a CUDA
    tensor by a Python number as a multiply by its reciprocal, which can
    differ in the last bit; a 0-dim divisor on ``x``'s device keeps the
    IEEE divide there."""
    if isinstance(x, torch.Tensor):
        return torch.div(x, torch.tensor(n, dtype=x.dtype, device=x.device))
    return (x / n).astype(x.dtype)


def tensors_sha256(tensors: Iterable[torch.Tensor]) -> str:
    """sha256 of the tensors' shapes, dtypes and bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (under autograd its gradient flows back to
    the DTensor; under ``no_grad`` it is the live storage), or the tensor
    itself."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t
