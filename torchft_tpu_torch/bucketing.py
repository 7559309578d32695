"""Pytree bucketing for the managed allreduce.

Counterpart of ``torchft_tpu/bucketing.py:85-310``, on torch tensors: a
pytree of many leaves becomes a handful of flat same-dtype buckets, one
collective each.

- :func:`tree_flatten` flattens a pytree in the reference's leaf order:
  ``jax.tree_util`` visits a dict's keys sorted, torch's pytree in
  insertion order. Buckets, and so the fp8 rows and their scales, follow
  that order, or the results would differ from the reference's.
- :func:`plan_for` caches a :class:`BucketPlan` (bucket membership and
  unpack metadata, a pure function of the leaves' shapes and dtypes) per
  (tree spec, leaf specs, cap): a training loop pays the grouping once,
  and per-plan state (the Manager's error-feedback residuals) lives as
  long as the plan.
- :class:`BufferPool` recycles flat buffers keyed by (dtype, size,
  device).
- :func:`pack` / :func:`unpack` / :func:`unpack_bucket` materialize and
  slice buckets: a group of tensors on one device is one ``torch.cat``
  there (a fresh buffer: a private capture of the leaves); other groups
  copy into a pooled (or fresh) CPU buffer.

Bucketing is bitwise-transparent for an elementwise reduction: packing
changes neither an element's dtype nor the order in which replicas' values
are summed.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "DEFAULT_BUCKET_CAP_BYTES",
    "BucketPlan",
    "BufferPool",
    "build_plan",
    "plan_for",
    "pack",
    "unpack",
    "unpack_bucket",
    "tree_flatten",
]

# 1 GiB default bucket cap (the reference's, bucketing.py:56)
DEFAULT_BUCKET_CAP_BYTES = 1 << 30

# metas entry: (leaf_index, offset_elems, size_elems, shape)
Meta = Tuple[int, int, int, Tuple[int, ...]]


def _sorted_dicts(tree: Any) -> Any:
    """``tree`` with every plain dict's keys in sorted order (an
    OrderedDict keeps its order, as in jax.tree_util)."""
    if isinstance(tree, OrderedDict):
        return OrderedDict((k, _sorted_dicts(v)) for k, v in tree.items())
    if type(tree) is dict:
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted_dicts(v) for v in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_sorted_dicts(v) for v in tree))
    return tree


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``torch.utils._pytree.tree_flatten`` in jax.tree_util's leaf order
    (dict keys sorted). Unflattening gives dicts whose keys iterate in
    sorted order, as jax.tree_util's do."""
    return pytree.tree_flatten(_sorted_dicts(tree))


def _leaf_dtype(leaf: Any) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype


def _leaf_size(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel()
    return int(np.asarray(leaf).size)


def _leaf_shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


class BucketPlan:
    """Bucket membership and unpack metadata for one leaf list: a pure
    function of the leaves' (shape, dtype) sequence and the cap, holding no
    data, so one plan serves every step over the same tree."""

    # weakref-able: the Manager keys per-bucket error-feedback residuals by
    # plan identity, so they die with the plan
    __slots__ = (
        "groups", "metas", "sizes", "dtypes", "num_leaves", "cap_bytes", "__weakref__",
    )

    def __init__(
        self,
        groups: List[List[int]],
        metas: List[List[Meta]],
        sizes: List[int],
        dtypes: List[torch.dtype],
        num_leaves: int,
        cap_bytes: int,
    ) -> None:
        self.groups = groups
        self.metas = metas
        self.sizes = sizes  # flat element count per bucket
        self.dtypes = dtypes  # dtype per bucket
        self.num_leaves = num_leaves
        self.cap_bytes = cap_bytes

    def __len__(self) -> int:
        return len(self.groups)


def build_plan(leaves: Sequence[Any], cap_bytes: int) -> BucketPlan:
    """Group leaf indices into flat same-dtype buckets of at most
    ``cap_bytes`` (a single leaf above the cap gets its own bucket); dtypes
    in order of first appearance, leaves in order within a dtype."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(_leaf_dtype(leaf), []).append(i)
    groups: List[List[int]] = []
    dtypes: List[torch.dtype] = []
    for dtype, idxs in by_dtype.items():
        itemsize = dtype.itemsize
        cur: List[int] = []
        cur_bytes = 0
        for i in idxs:
            nbytes = _leaf_size(leaves[i]) * itemsize
            if cur and cur_bytes + nbytes > cap_bytes:
                groups.append(cur)
                dtypes.append(dtype)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            groups.append(cur)
            dtypes.append(dtype)
    metas: List[List[Meta]] = []
    sizes: List[int] = []
    for g in groups:
        offset = 0
        group_metas: List[Meta] = []
        for i in g:
            size = _leaf_size(leaves[i])
            group_metas.append((i, offset, size, _leaf_shape(leaves[i])))
            offset += size
        metas.append(group_metas)
        sizes.append(offset)
    return BucketPlan(groups, metas, sizes, dtypes, len(leaves), cap_bytes)


# plan cache, cleared wholesale when full: a trainer touches a handful of
# trees, and the cache exists to take the grouping off every step
_plan_cache: Dict[Any, BucketPlan] = {}
_plan_cache_lock = threading.Lock()
_PLAN_CACHE_MAX = 128


def plan_for(leaves: Sequence[Any], cap_bytes: int, treedef: Any = None) -> BucketPlan:
    """Memoized :func:`build_plan`, keyed by (treedef, leaf specs, cap).
    The (dtype, shape) spec keeps a same-structure tree of other leaf
    geometry from sharing a plan."""
    spec = tuple((str(_leaf_dtype(l)), _leaf_shape(l)) for l in leaves)
    key: Any = (treedef, spec, cap_bytes)
    try:
        hash(key)
    except TypeError:  # a spec type without a hash: key by its text
        key = (repr(treedef), spec, cap_bytes)
    with _plan_cache_lock:
        plan = _plan_cache.get(key)
    if plan is not None:
        return plan
    plan = build_plan(leaves, cap_bytes)
    with _plan_cache_lock:
        if len(_plan_cache) >= _PLAN_CACHE_MAX:
            _plan_cache.clear()
        _plan_cache[key] = plan
    return plan


class BufferPool:
    """Reusable flat buffers keyed by (dtype, size, device).

    ``acquire`` returns a recycled buffer when one is free, else allocates;
    ``release`` returns one for reuse, keeping at most ``max_per_key`` per
    key. Thread-safe."""

    def __init__(self, max_per_key: int = 4) -> None:
        self._lock = threading.Lock()
        self._free: Dict[Tuple[torch.dtype, int, str], List[torch.Tensor]] = {}
        self._max_per_key = max_per_key
        self.hits = 0
        self.misses = 0

    def acquire(self, size: int, dtype: torch.dtype, device: Any = "cpu") -> torch.Tensor:
        key = (dtype, int(size), str(torch.device(device)))
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                self.hits += 1
                return bucket.pop()
            self.misses += 1
        return torch.empty(int(size), dtype=dtype, device=device)

    def release(self, buf: torch.Tensor) -> None:
        if not isinstance(buf, torch.Tensor) or buf.dim() != 1:
            return
        key = (buf.dtype, buf.shape[0], str(buf.device))
        with self._lock:
            bucket = self._free.setdefault(key, [])
            if len(bucket) < self._max_per_key:
                bucket.append(buf)


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.ascontiguousarray(leaf))


def pack(
    leaves: Sequence[Any], plan: BucketPlan, pool: Optional[BufferPool] = None
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plan's buckets of ``leaves``, as ``(flats, pooled)``: one flat
    tensor per bucket, and those of them that came from ``pool`` (the
    caller releases them once the collective has resolved). A group of
    tensors on one device is concatenated there; any other group is copied
    into a CPU buffer. Either way a private copy of the leaves."""
    flats: List[torch.Tensor] = []
    pooled: List[torch.Tensor] = []
    for g, metas, size, dtype in zip(plan.groups, plan.metas, plan.sizes, plan.dtypes):
        members = [leaves[i] for i in g]
        devices = {m.device for m in members if isinstance(m, torch.Tensor)}
        if len(devices) == 1 and all(isinstance(m, torch.Tensor) for m in members):
            if len(g) == 1:
                flat = members[0].detach().reshape(-1).clone()
            else:
                flat = torch.cat([m.detach().reshape(-1) for m in members])
        else:
            if pool is not None:
                flat = pool.acquire(size, dtype)
                pooled.append(flat)
            else:
                flat = torch.empty(size, dtype=dtype)
            for (i, off, n, _shape) in metas:
                flat[off:off + n] = _as_tensor(leaves[i]).reshape(-1).cpu()
        flats.append(flat)
    return flats, pooled


def unpack_bucket(flat: Any, plan: BucketPlan, bucket: int) -> List[Tuple[int, Any]]:
    """Slice ONE reduced bucket into ``(leaf_index, view)`` pairs."""
    return [
        (i, flat[off:off + size].reshape(shape))
        for (i, off, size, shape) in plan.metas[bucket]
    ]


def unpack(flats: Sequence[Any], plan: BucketPlan) -> List[Any]:
    """Slice the reduced flat buckets back into per-leaf views, in leaf
    order."""
    out: List[Optional[Any]] = [None] * plan.num_leaves
    for b, flat in enumerate(flats):
        for i, view in unpack_bucket(flat, plan, b):
            out[i] = view
    if any(o is None for o in out):
        raise ValueError("the buckets do not cover every leaf of the plan")
    return out
