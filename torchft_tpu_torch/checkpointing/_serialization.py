"""State-dict (de)serialization for checkpoint transports.

Counterpart of ``torchft_tpu/checkpointing/_serialization.py`` over torch
pytrees (``torch.utils._pytree``): the tree structure and per-leaf
``TensorMeta`` travel as a pickled spec; tensor payloads are raw host
bytes that transports stream by byte range. CUDA leaves are staged through
host memory on send and re-land on the template's device on receive.
``TensorMeta`` names dtypes as numpy does (``float32``, ``bfloat16``), so
for equal arrays the two packages' metas and payload bytes are equal.

The in-place receive's helpers (``can_absorb``, ``template_leaves_for``,
``place_leaf_like``) work on torch tensors on any device and on host
ndarrays: placing a leaf onto a CUDA template leaf is a ``copy_`` into that
leaf, the counterpart of the reference's ``device_put`` to the template's
sharding, and never allocates a second copy of the state on the card.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "TensorMeta",
    "TreeSpecPayload",
    "alloc_leaf",
    "can_absorb",
    "describe_state",
    "flatten_state",
    "leaf_from_bytes",
    "payload_memoryview",
    "place_leaf_like",
    "place_state_like",
    "split_chunks",
    "template_leaves_for",
    "tree_from_leaves",
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


def describe_state(state: Any) -> Tuple[TreeSpecPayload, List[Any]]:
    """A state pytree's spec and its leaves, with no copy: tensor leaves
    detached, every other leaf pickled to bytes (its payload)."""
    leaves, treedef = pytree.tree_flatten(state)
    metas: List[TensorMeta] = []
    out: List[Any] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            metas.append(TensorMeta(
                dtype=_dtype_name(t.dtype), shape=tuple(t.shape),
                nbytes=t.numel() * t.element_size(),
            ))
            out.append(t)
        else:
            buf = pickle.dumps(leaf)
            metas.append(TensorMeta(dtype="", shape=(), nbytes=len(buf), kind="pickled"))
            out.append(buf)
    skeleton = pytree.tree_unflatten(list(range(len(leaves))), treedef)
    return TreeSpecPayload(pickle.dumps(skeleton), metas), out


def flatten_state(
    state: Any, snapshot: bool = True
) -> Tuple[TreeSpecPayload, List[Any]]:
    """Flatten a state pytree into (spec, per-leaf payloads).

    Tensor leaves become host uint8 ndarrays holding their bytes: one
    device-to-host copy for a CUDA leaf; for a CPU leaf a copy when
    ``snapshot`` (a served checkpoint cannot tear while training mutates
    the live state), else a view of its memory where it is contiguous (a
    transport whose send completes before it returns streams straight from
    the caller's tensors). Other leaves are pickled bytes."""
    spec, leaves = describe_state(state)
    payloads: List[Any] = []
    for t in leaves:
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                host = t.cpu()
            else:
                host = t.clone() if snapshot else t
            # an empty tensor's flat view has stride 0, which .view refuses
            t = (host.contiguous().reshape(-1).view(torch.uint8).numpy()
                 if host.numel() else np.zeros(0, np.uint8))
        payloads.append(t)
    return spec, payloads


def payload_memoryview(payload: Any) -> memoryview:
    """A flat byte view of a staged payload (uint8 array or bytes)."""
    return memoryview(payload).cast("B")


def alloc_leaf(meta: TensorMeta) -> bytearray:
    """The receive buffer of one leaf; the wire is read straight into it."""
    return bytearray(meta.nbytes)


def leaf_from_bytes(meta: TensorMeta, buf: Any) -> Any:
    """A leaf rebuilt from its received bytes (bytes, a bytearray, or a
    uint8 ndarray or CPU tensor off a process group receive): a CPU tensor
    of the meta's dtype and shape, sharing the buffer's memory where it may
    (a fresh wire buffer), or the unpickled value."""
    if meta.kind == "pickled":
        if isinstance(buf, torch.Tensor):
            buf = buf.numpy()
        return pickle.loads(bytes(buf))
    if isinstance(buf, torch.Tensor):
        raw = buf.reshape(-1).view(torch.uint8)
    elif isinstance(buf, np.ndarray):
        raw = torch.from_numpy(np.ascontiguousarray(buf).reshape(-1).view(np.uint8))
    elif isinstance(buf, bytes):
        raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8) if buf else None
    else:
        raw = torch.frombuffer(buf, dtype=torch.uint8) if len(buf) else None
    if raw is None:
        raw = torch.empty(0, dtype=torch.uint8)
    if raw.numel() != meta.nbytes:
        raise ValueError(f"leaf of {meta.nbytes} bytes got {raw.numel()}")
    return raw.view(_torch_dtype(meta.dtype)).reshape(meta.shape)


def split_chunks(payload_sizes: Sequence[int], num_chunks: int) -> List[List[int]]:
    """Greedy size-balanced assignment of leaf indices to chunks."""
    num_chunks = max(1, min(num_chunks, max(len(payload_sizes), 1)))
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    sizes = [0] * num_chunks
    order = sorted(range(len(payload_sizes)), key=lambda i: -payload_sizes[i])
    for i in order:
        j = min(range(num_chunks), key=lambda k: sizes[k])
        chunks[j].append(i)
        sizes[j] += payload_sizes[i]
    return chunks


def _dtype_str(dtype: Any) -> str:
    """A dtype's name as ``TensorMeta`` writes it, for a name, a torch
    dtype or a numpy dtype."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return _dtype_name(dtype)
    return np.dtype(dtype).name


def can_absorb(
    template: Any, shape: Tuple[int, ...], dtype: Any, require_contiguous: bool = False
) -> bool:
    """Whether ``template`` (a tensor on any device, or a host ndarray) can
    take an incoming leaf of ``shape`` and ``dtype`` in place. One
    predicate for every in-place path. ``require_contiguous`` is for
    receives that stream bytes straight into the template's memory, where a
    non-contiguous flat view would be a copy."""
    if isinstance(template, torch.Tensor):
        return (
            tuple(template.shape) == tuple(shape)
            and _dtype_name(template.dtype) == _dtype_str(dtype)
            and (not require_contiguous or template.is_contiguous())
        )
    if not isinstance(template, np.ndarray):
        return False
    return (
        template.shape == tuple(shape)
        and template.dtype.name == _dtype_str(dtype)
        and template.flags.writeable
        and (not require_contiguous or template.flags["C_CONTIGUOUS"])
    )


def template_leaves_for(spec: TreeSpecPayload, template: Any, logger: Any) -> Optional[List[Any]]:
    """``template``'s leaves for index-aligned in-place placement, or None
    (with one warning) when the sender's tree structure differs from the
    template's: placement matches leaves by flat index, so a structural
    drift with shape-coincident leaves would land sender data in the wrong
    live buffers. On a mismatch the receive goes to wire buffers instead."""
    s_order, s_def = pytree.tree_flatten(pickle.loads(spec.treedef_bytes))
    t_leaves, t_def = pytree.tree_flatten(template)
    if s_def != t_def or s_order != list(range(len(s_order))):
        logger.warning(
            "sender tree structure differs from the template's; in-place "
            "receive degraded to wire buffers for this transfer (sender %s vs "
            "template %s)", str(s_def)[:200], str(t_def)[:200],
        )
        return None
    return t_leaves


def place_leaf_like(host_leaf: torch.Tensor, template: Any, logger: Any) -> Any:
    """Land a received leaf where the template leaf lives: ``copy_`` into a
    tensor template of its dtype and shape (on the card: one host-to-device
    copy into the template's own storage) and return the template (a live
    parameter is written without bumping its autograd version). A
    template that cannot absorb the leaf is never coerced: one "in-place
    receive degraded" warning, and the wire leaf is returned."""
    try:
        if isinstance(template, np.ndarray):
            template_t = torch.from_numpy(template) if template.flags.writeable else None
        else:
            template_t = template
        if isinstance(template_t, torch.Tensor) and can_absorb(
            template_t, tuple(host_leaf.shape), host_leaf.dtype
        ):
            # through ``.data``: an alias with a version counter of its own,
            # so a heal landing while the healing replica's own (discarded)
            # backward still holds the leaf does not fail that backward
            template_t.data.copy_(host_leaf)
            return template
        logger.warning(
            "template leaf cannot absorb received leaf (template %s shape=%s "
            "dtype=%s vs received shape=%s dtype=%s); falling back to the wire "
            "buffer: in-place receive degraded",
            type(template).__name__, getattr(template, "shape", None),
            getattr(template, "dtype", None), tuple(host_leaf.shape), host_leaf.dtype,
        )
    except Exception:  # noqa: BLE001 - fall back to the wire buffer
        logger.exception("failed to place leaf onto template")
    return host_leaf


def place_state_like(state: Any, template: Any, logger: Any) -> Any:
    """``state`` with each tensor leaf landed in the matching leaf of
    ``template`` (a pytree of the same structure) by ``place_leaf_like``:
    on the card one host-to-device copy into the template's own storage.
    Other leaves stay ``state``'s. A template of another structure takes
    nothing (``template_leaves_for``'s one warning) and ``state`` is
    returned as it is."""
    leaves, treedef = pytree.tree_flatten(state)
    t_leaves, t_def = pytree.tree_flatten(template)
    if t_def != treedef:
        logger.warning(
            "state structure differs from the template's; in-place placement "
            "degraded (state %s vs template %s)", str(treedef)[:200], str(t_def)[:200],
        )
        return state
    return pytree.tree_unflatten([
        place_leaf_like(leaf, t, logger) if isinstance(leaf, torch.Tensor) else leaf
        for leaf, t in zip(leaves, t_leaves)
    ], treedef)


def _is_final(meta: TensorMeta, buf: Any) -> bool:
    """Whether a payload is already the leaf, not its bytes (for a uint8
    leaf the two are the same)."""
    return (isinstance(buf, torch.Tensor) and _dtype_name(buf.dtype) == meta.dtype
            and tuple(buf.shape) == tuple(meta.shape))


def tree_from_leaves(spec: TreeSpecPayload, leaves: Sequence[Any]) -> Any:
    """The pytree of ``spec``'s structure holding ``leaves`` (final leaves,
    in flat order)."""
    order, treedef = pytree.tree_flatten(pickle.loads(spec.treedef_bytes))
    if sorted(order) != list(range(len(spec.leaves))):
        raise ValueError("checkpoint structure does not match its leaf metadata")
    return pytree.tree_unflatten([leaves[i] for i in order], treedef)


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
        if meta.kind == "array" and _is_final(meta, buf):
            # already a leaf: landed in place, or placed on its device
            leaves.append(buf)
            continue
        t = leaf_from_bytes(meta, buf)
        leaves.append(t.to(device) if device is not None and meta.kind == "array" else t)
    return pytree.tree_unflatten([leaves[i] for i in order], treedef)
