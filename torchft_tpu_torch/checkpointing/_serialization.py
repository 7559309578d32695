"""State-dict (de)serialization for checkpoint transports.

Counterpart of ``torchft_tpu/checkpointing/_serialization.py`` over torch
pytrees (``torch.utils._pytree``): the tree structure and per-leaf
``TensorMeta`` travel as a pickled spec; tensor payloads are raw host
bytes that transports stream by byte range. CUDA leaves are staged through
host memory on send and re-land on the template's device on receive.
``TensorMeta`` names dtypes as numpy does (``float32``, ``bfloat16``), so
for equal arrays the two packages' metas and payload bytes are equal.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

__all__ = [
    "TensorMeta",
    "TreeSpecPayload",
    "alloc_leaf",
    "flatten_state",
    "payload_memoryview",
    "unflatten_state",
]


@dataclass
class TensorMeta:
    """Per-leaf metadata: dtype name, shape, byte count, and whether the
    leaf is a tensor ("array") or a pickled Python value ("pickled")."""

    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    kind: str = "array"


@dataclass
class TreeSpecPayload:
    """Pickled header: tree structure + leaf metadata. The structure is
    the state's containers with each leaf replaced by its index (plain
    dicts, lists and tuples pickle stably; torch's TreeSpec objects do
    not)."""

    treedef_bytes: bytes
    leaves: List[TensorMeta] = field(default_factory=list)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown tensor dtype {name!r}")
    return dtype


def flatten_state(state: Any) -> Tuple[TreeSpecPayload, List[Any]]:
    """Flatten a state pytree into (spec, per-leaf payloads).

    Tensor leaves become host uint8 ndarrays holding their bytes: a copy
    for every leaf (one device-to-host copy for CUDA ones), so a served
    checkpoint cannot tear while training mutates the live state. Other
    leaves are pickled bytes."""
    leaves, treedef = pytree.tree_flatten(state)
    metas: List[TensorMeta] = []
    payloads: List[Any] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            host = t.cpu() if t.is_cuda else t.clone()
            host = host.contiguous().reshape(-1).view(torch.uint8).numpy()
            metas.append(TensorMeta(
                dtype=_dtype_name(t.dtype), shape=tuple(t.shape), nbytes=host.nbytes
            ))
            payloads.append(host)
        else:
            buf = pickle.dumps(leaf)
            metas.append(TensorMeta(dtype="", shape=(), nbytes=len(buf), kind="pickled"))
            payloads.append(buf)
    skeleton = pytree.tree_unflatten(list(range(len(leaves))), treedef)
    return TreeSpecPayload(pickle.dumps(skeleton), metas), payloads


def payload_memoryview(payload: Any) -> memoryview:
    """A flat byte view of a staged payload (uint8 array or bytes)."""
    return memoryview(payload).cast("B")


def alloc_leaf(meta: TensorMeta) -> bytearray:
    """The receive buffer of one leaf; the wire is read straight into it."""
    return bytearray(meta.nbytes)


def unflatten_state(
    spec: TreeSpecPayload, payloads: Sequence[Any], template: Optional[Any] = None
) -> Any:
    """Rebuild the pytree from received buffers. Tensor leaves land on the
    CPU, or on the device of the matching leaf of ``template`` (a pytree of
    the same structure) when one is given."""
    order, treedef = pytree.tree_flatten(pickle.loads(spec.treedef_bytes))
    if sorted(order) != list(range(len(spec.leaves))):
        raise ValueError("checkpoint structure does not match its leaf metadata")
    devices: List[Optional[torch.device]] = [None] * len(spec.leaves)
    if template is not None:
        t_leaves, t_def = pytree.tree_flatten(template)
        if t_def != treedef:
            raise ValueError("received state does not match the template's structure")
        devices = [t.device if isinstance(t, torch.Tensor) else None for t in t_leaves]
    leaves = []
    for meta, buf, device in zip(spec.leaves, payloads, devices):
        if meta.kind == "pickled":
            leaves.append(pickle.loads(bytes(buf)))
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8) if meta.nbytes else (
            torch.empty(0, dtype=torch.uint8)
        )
        t = raw.view(_torch_dtype(meta.dtype)).reshape(meta.shape)
        leaves.append(t.to(device) if device is not None else t)
    return pytree.tree_unflatten([leaves[i] for i in order], treedef)
