"""Durable (tier-2) checkpoints for fault-tolerant training, on
``torch.distributed.checkpoint`` (DCP): the port's counterpart of
``torchft_tpu/checkpointing/durable.py``.

Checkpoints come in two tiers. Tier 1, live recovery, heals a rejoining
replica from a healthy peer's memory (the ``CheckpointTransport``s): fast,
but it needs one live replica, so a whole-job outage loses everything.
Tier 2 snapshots the state to persistent storage every
``save_interval_steps`` committed steps. A step holds the composition the
reference saves as one atomic item: the user state, the Manager's quorum
clock (``state_dict()``, as JSON) and the data iterator's position (as
JSON), so a cold-started job resumes where the fleet died.

Layout, one directory a replica group::

    <directory>/<step>/rank_<r>/     DCP's files of group rank r's tensors
    <directory>/<step>/rank_<r>.json its tree, the Manager's and the data
                                     iterator's state, bytes, digest
    <directory>/.tmp-<step>/         a step being written

Every group rank writes its own tensors with ``no_dist`` (DCP over the
in-group process group would take equal keys of plain local-shard tensors
as replicated and keep one rank's copy), into the step's temporary
directory; its ``rank_<r>.json`` lands last. Group rank 0 renames the
directory to its step once every rank's file is there, so ``latest_step``,
``all_steps`` and ``restore`` never see an unfinished step, and a process
killed mid-save leaves the previous step the latest; retention then prunes
finished steps beyond ``max_to_keep``. Group rank 0 removes what a dead
incarnation left unfinished when it starts.

A save copies the tensors to host memory on the caller's thread (they are
trained on in place right after) and writes them on a thread of its own:
the step that saves does not wait for the disk. ``wait()`` / ``close()``
block until the write has landed. ``restore`` reads through host memory
and copies each tensor into the template's tensor at the same place of the
tree, on its device, in place.

Usage::

    ckpt = DurableCheckpointer(dir, max_to_keep=3, save_interval_steps=100)
    restored = ckpt.restore(state_template=manager.user_state_dict())
    if restored is not None:
        state, manager_sd, data_sd = restored
        manager.load_user_state_dict(state)
        manager.load_state_dict(manager_sd)
        data_iter.load_state_dict(data_sd)
    ...
    ckpt.maybe_save(manager.current_step(), manager.user_state_dict,
                    manager=manager, data_iter=data_iter)
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["DurableCheckpointer", "set_save_fault_hook", "state_digest"]

_TMP_PREFIX = ".tmp-"
# DCP's writer threads for one rank's files
_WRITE_THREADS = 4
_DIGEST_THREADS = 4
# how long a rank waits for its group's other ranks to land a step
_COMMIT_TIMEOUT_S = 600.0

# Test-only fault injection: called on the writer thread with (point, step)
# at "written" (this rank's tensors are on disk, its json is not yet).
_save_fault_hook: Optional[Callable[[str, int], None]] = None


def set_save_fault_hook(hook: Optional[Callable[[str, int], None]]) -> None:
    """Install (or clear, with None) the process-wide save fault hook."""
    global _save_fault_hook
    _save_fault_hook = hook


# ------------------------------------------------------------- the tree
def _encode_key(key: Any) -> List[Any]:
    if isinstance(key, bool) or not isinstance(key, (str, int)):
        raise TypeError(f"durable checkpoints take str or int dict keys, not {key!r}")
    return ["int" if isinstance(key, int) else "str", key]


def _flatten(tree: Any, leaves: List[Any], path: Tuple = ()) -> Tuple[Dict[str, Any], List]:
    """(the tree's JSON description, its leaves' paths); array leaves are
    appended to ``leaves`` (torch tensors, numpy arrays), JSON scalars stay
    in the description."""
    paths: List[Tuple] = []

    def walk(node: Any, path: Tuple) -> Dict[str, Any]:
        if isinstance(node, dict):
            keys = list(node)
            return {"t": "dict", "k": [_encode_key(k) for k in keys],
                    "v": [walk(node[k], path + (k,)) for k in keys]}
        if isinstance(node, (list, tuple)):
            return {"t": type(node).__name__,
                    "v": [walk(v, path + (i,)) for i, v in enumerate(node)]}
        if isinstance(node, (torch.Tensor, np.ndarray)):
            kind = "tensor" if isinstance(node, torch.Tensor) else "numpy"
            t = node if kind == "tensor" else torch.from_numpy(np.ascontiguousarray(node))
            leaves.append(node)
            paths.append(path)
            return {"t": kind, "i": len(leaves) - 1, "shape": list(t.shape),
                    "dtype": str(t.dtype).replace("torch.", "")}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"t": "value", "v": node}
        raise TypeError(f"durable checkpoints take tensors, numpy arrays, JSON scalars, dicts, "
                        f"lists and tuples, not {type(node).__name__}")

    return walk(tree, path), paths


def _unflatten(desc: Dict[str, Any], leaves: List[Any]) -> Any:
    t = desc["t"]
    if t == "dict":
        return {k: _unflatten(v, leaves) for (_, k), v in zip(desc["k"], desc["v"])}
    if t in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in desc["v"]]
        return out if t == "list" else tuple(out)
    if t == "value":
        return desc["v"]
    return leaves[desc["i"]]


def _leaf_descs(desc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The array leaves' descriptions, in index order."""
    out: List[Dict[str, Any]] = []

    def walk(d: Dict[str, Any]) -> None:
        if d["t"] in ("dict", "list", "tuple"):
            for v in d["v"]:
                walk(v)
        elif d["t"] in ("tensor", "numpy"):
            out.append(d)

    walk(desc)
    return sorted(out, key=lambda d: d["i"])


def _leaf_sha256(t: torch.Tensor) -> str:
    h = hashlib.sha256(f"{tuple(t.shape)}{t.dtype}".encode())
    # hashlib releases the GIL on large buffers: leaves hash in parallel
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def state_digest(tensors: List[torch.Tensor]) -> str:
    """sha256 over the sha256 of each host tensor's shape, dtype and bytes,
    in order: what a save's record and a restore's record carry."""
    with ThreadPoolExecutor(_DIGEST_THREADS) as pool:
        parts = list(pool.map(_leaf_sha256, tensors))
    return hashlib.sha256("".join(parts).encode()).hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json(path: str, obj: Any) -> None:
    """``obj`` as JSON at ``path``, atomically and durably."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class DurableCheckpointer:
    """Periodic durable checkpoints of (user state, manager clock, data
    position) with retention, on DCP.

    Each replica group checkpoints on its own (pass a directory a group);
    on a cold start every group restores its own latest step and the first
    quorum brings stragglers level by a live heal. ``group_rank`` /
    ``group_world_size`` default to the default process group's (the
    replica group's in-group group), else 0 / 1. With ``digest`` each
    landed save and each restore records the ``state_digest`` of its
    tensors. ``on_saved(record)`` runs on the writer thread when a save
    has landed; ``saved`` holds every record (``step``, ``bytes``,
    ``issue_s``: the caller's share, ``land_s``: from the call to the
    landing, of it ``write_s``: DCP's write and ``digest_s``: the digest,
    which run side by side, ``sha256``), ``last_restore`` the last restore's (``step``,
    ``bytes``, ``restore_s``, ``sha256``)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_interval_steps: int = 0,
        group_rank: Optional[int] = None,
        group_world_size: Optional[int] = None,
        digest: bool = False,
        on_saved: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        in_group = dist.is_available() and dist.is_initialized()
        self._rank = group_rank if group_rank is not None else (
            dist.get_rank() if in_group else 0)
        self._world = group_world_size if group_world_size is not None else (
            dist.get_world_size() if in_group else 1)
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._interval = save_interval_steps
        self._digest = digest
        self._on_saved = on_saved
        os.makedirs(self._directory, exist_ok=True)
        if self._rank == 0:
            for name in os.listdir(self._directory):
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self._directory, name), ignore_errors=True)
        self._executor = ThreadPoolExecutor(1, thread_name_prefix="durable_ckpt")
        self._pending: Optional[Future] = None
        self._pending_step: Optional[int] = None
        self.saved: List[Dict[str, Any]] = []
        self.last_restore: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ save
    def maybe_save(self, step: int, state: Any, manager: Any = None,
                   data_iter: Any = None) -> bool:
        """Save iff ``step`` is on the interval and new; returns whether a
        save was issued. ``state`` may be a zero-argument callable, called
        only when a save happens (``manager.user_state_dict`` takes the
        state-dict read lock: the steps that skip pay nothing)."""
        if step <= 0:  # never burn a retention slot on untrained init state
            return False
        if self._interval <= 0 or step % self._interval != 0:
            return False
        if self.latest_step() == step or self._pending_step == step:
            return False
        if callable(state):
            state = state()
        return self.save(step, state, manager=manager, data_iter=data_iter)

    def save(self, step: int, state: Any, manager: Any = None, data_iter: Any = None,
             force: bool = False) -> bool:
        """Snapshot ``state`` (a tree of tensors, numpy arrays and JSON
        scalars) with the Manager's clock and the data iterator's position.
        The tensors are copied to host memory here and written on the
        writer thread: ``wait()`` before the process exits. As orbax's
        manager: a step not after the latest is skipped (False) unless
        ``force``, and a forced step already saved raises
        ``FileExistsError``."""
        t0 = time.perf_counter()
        self.wait()
        latest = self.latest_step()
        if latest is not None and step <= latest and not force:
            return False
        if os.path.isdir(os.path.join(self._directory, str(step))):
            raise FileExistsError(f"durable step {step} already exists in {self._directory}")
        leaves: List[Any] = []
        tree, _ = _flatten(state, leaves)
        staged: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for i, leaf in enumerate(leaves):
                if isinstance(leaf, np.ndarray):
                    staged[str(i)] = torch.from_numpy(np.array(leaf, copy=True, order="C"))
                else:
                    host = torch.empty(leaf.shape, dtype=leaf.dtype)
                    host.copy_(leaf.detach())  # synchronous: the next step trains in place
                    staged[str(i)] = host
        meta = {
            "step": step,
            "tree": tree,
            "torchft": manager.state_dict() if manager is not None else None,
            "data": data_iter.state_dict() if data_iter is not None else None,
            "bytes": sum(t.nbytes for t in staged.values()),
        }
        issue_s = time.perf_counter() - t0
        self._pending_step = step
        self._pending = self._executor.submit(self._write, step, staged, meta, t0, issue_s)
        return True

    def _write(self, step: int, staged: Dict[str, torch.Tensor], meta: Dict[str, Any],
               t0: float, issue_s: float) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self._directory, f"{_TMP_PREFIX}{step}")
        rank_dir = os.path.join(tmp, f"rank_{self._rank}")
        shutil.rmtree(rank_dir, ignore_errors=True)
        os.makedirs(rank_dir, exist_ok=True)
        def timed_digest():
            t = time.perf_counter()
            return state_digest(list(staged.values())), time.perf_counter() - t

        with ThreadPoolExecutor(1) as hasher:
            digest = hasher.submit(timed_digest) if self._digest else None
            t_write = time.perf_counter()
            dcp.save(staged, storage_writer=dcp.FileSystemWriter(
                rank_dir, thread_count=_WRITE_THREADS), no_dist=True)
            write_s = time.perf_counter() - t_write
            meta["sha256"], digest_s = digest.result() if digest is not None else (None, 0.0)
        if _save_fault_hook is not None:
            _save_fault_hook("written", step)
        _write_json(os.path.join(tmp, f"rank_{self._rank}.json"), meta)
        final = os.path.join(self._directory, str(step))
        deadline = time.monotonic() + _COMMIT_TIMEOUT_S
        if self._rank == 0:
            # every rank's json lands after its tensors: then the step is whole
            want = [os.path.join(tmp, f"rank_{r}.json") for r in range(self._world)]
            while not all(os.path.exists(p) for p in want):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"durable step {step}: the group's other ranks did not "
                                       f"land within {_COMMIT_TIMEOUT_S} s")
                time.sleep(0.02)
            os.rename(tmp, final)
            _fsync_dir(self._directory)
            self._prune()
        else:
            while not os.path.isdir(final):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"durable step {step}: group rank 0 did not finish it "
                                       f"within {_COMMIT_TIMEOUT_S} s")
                time.sleep(0.02)
        record = {"step": step, "bytes": meta["bytes"], "issue_s": issue_s,
                  "land_s": time.perf_counter() - t0, "write_s": write_s, "digest_s": digest_s,
                  "sha256": meta["sha256"]}
        self.saved.append(record)
        logger.info(f"durable checkpoint saved at step {step}")
        if self._on_saved is not None:
            self._on_saved(record)

    def _prune(self) -> None:
        steps = self.all_steps()
        if self._max_to_keep is None or self._max_to_keep <= 0:
            return
        for old in steps[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._directory, str(old)), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(
        self, state_template: Any = None, step: Optional[int] = None
    ) -> Optional[Tuple[Any, Optional[dict], Optional[dict]]]:
        """``(state, manager_state_dict, data_state_dict)`` of ``step``
        (default: the latest), or None when there is none. With
        ``state_template`` (a tree like the saved one, e.g. the live state)
        each tensor lands in the template's tensor at the same place, on
        its device, in place; the others come back as host tensors (numpy
        arrays where numpy arrays were saved)."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        step_dir = os.path.join(self._directory, str(step))
        with open(os.path.join(step_dir, f"rank_{self._rank}.json")) as f:
            meta = json.load(f)
        descs = _leaf_descs(meta["tree"])
        host = {str(d["i"]): torch.empty(d["shape"], dtype=getattr(torch, d["dtype"]))
                for d in descs}
        if host:
            dcp.load(host, checkpoint_id=os.path.join(step_dir, f"rank_{self._rank}"),
                     no_dist=True)
        tensors = [host[str(d["i"])] for d in descs]
        targets: Dict[Tuple, Any] = {}
        if state_template is not None:
            tmpl_leaves: List[Any] = []
            _, paths = _flatten(state_template, tmpl_leaves)
            targets = dict(zip(paths, tmpl_leaves))
        _, saved_paths = _flatten(_unflatten(meta["tree"], tensors), [])
        leaves: List[Any] = []
        # the digest reads the host copies while they go to the template
        with ThreadPoolExecutor(1) as hasher, torch.no_grad():
            digest = hasher.submit(state_digest, tensors) if self._digest else None
            for d, path, t in zip(descs, saved_paths, tensors):
                dst = targets.get(path)
                if isinstance(dst, torch.Tensor):
                    if tuple(dst.shape) != tuple(t.shape) or dst.dtype != t.dtype:
                        raise ValueError(f"durable step {step}: {path} is {tuple(t.shape)} "
                                         f"{t.dtype}, the template's {tuple(dst.shape)} "
                                         f"{dst.dtype}")
                    dst.copy_(t)
                    leaves.append(dst)
                else:
                    leaves.append(t.numpy() if d["t"] == "numpy" else t)
            sha = digest.result() if digest is not None else None
        self.last_restore = {"step": step, "bytes": meta["bytes"],
                             "restore_s": time.perf_counter() - t0, "sha256": sha}
        return _unflatten(meta["tree"], leaves), meta["torchft"], meta["data"]

    # ------------------------------------------------------------- lifecycle
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The finished steps, ascending."""
        return sorted(int(n) for n in os.listdir(self._directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self._directory, n)))

    def wait(self) -> None:
        """Block until the write in flight has landed (re-raises its error)."""
        pending, self._pending = self._pending, None
        self._pending_step = None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)
