"""LocalSGD and (Streaming) DiLoCo: semi-synchronous training algorithms.

Counterpart of ``torchft_tpu/local_sgd.py`` (``LocalSGD`` ``:85-188``,
``partition_fragments`` ``:191-202``, ``_Fragment`` ``:216-438``,
``DiLoCo`` ``:441-694``). The API keeps the reference's shape: the caller
threads its parameter pytree through ``step(params)`` after every inner
optimizer step and continues with what it returns. Inside, PyTorch's idiom:
synced values are written IN PLACE, under ``torch.no_grad()``, into the
caller's leaf tensors, and the same tree comes back, so an ``nn.Module``'s
parameters stay the module's (``step(dict(model.named_parameters()))``).
Leaves are ordered as ``bucketing.tree_flatten`` orders them (dict keys
sorted, as jax.tree_util does), so fragments and buckets match the
reference's.

- LocalSGD: every ``sync_every`` steps a quorum, the allreduce (AVG) of
  the parameters and the commit vote; a commit adopts the average, a failed
  commit restores the last synced parameters.
- DiLoCo: the inner optimizer runs locally; every ``sync_every /
  num_fragments`` steps one fragment syncs: its pseudogradient (global
  minus local) is averaged across replica groups (fp8 with
  ``should_quantize``, whole, so that the Manager streams it as compressed
  buckets with error feedback), the outer optimizer steps the fragment's
  global copy, and the local parameters become
  ``global + alpha * (local - global)``. ``fragment_sync_delay`` steps of
  inner training overlap the allreduce. A failed commit restores the
  fragment's global copy. The fragment is picked from
  ``manager.current_step()``, so every replica syncs the same one, which
  needs the synchronous quorum (``use_async_quorum=False``).

The outer optimizer is a factory over a fragment's global tensors, e.g.
``lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True)``
(``optax.sgd(lr, momentum, nesterov=True)``'s recurrence); SGD's momentum
buffers are created, zero, up front (the first step is then bitwise the
step torch would take), so every heal carries one tree. Globals and
backups are private copies on the leaves' device, registered for live
recovery as ``StreamingDiLoCoFragment_{i}`` (the live tensors and the
optimizer's ``state_dict()``, whose tensors are references: an in-place
heal lands in them) and ``LocalSGD``. Knobs: ``TORCHFT_SYNC_EVERY`` (> 0
replaces the constructor's cadence), ``TORCHFT_USE_BUCKETIZATION`` (turns
bucketization on, never off).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import bucketing, knobs
from torchft_tpu_torch.checkpointing._serialization import split_chunks
from torchft_tpu_torch.process_group import ReduceOp
from torchft_tpu_torch.work import Work

logger = logging.getLogger(__name__)

__all__ = ["LocalSGD", "DiLoCo", "partition_fragments"]

OuterOptimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def _flatten(tree: Any) -> List[torch.Tensor]:
    leaves, _treedef = bucketing.tree_flatten(tree)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"parameter leaves must be tensors, got {type(leaf).__name__}")
    return leaves


def _copy_into(live: torch.Tensor, incoming: Any) -> None:
    """Land ``incoming`` in ``live``'s storage (a heal may hand CPU tensors
    or arrays to a CUDA leaf); through ``.data``, so a leaf's autograd
    version is left alone."""
    if incoming is live:
        return
    if not isinstance(incoming, torch.Tensor):
        incoming = torch.from_numpy(np.ascontiguousarray(incoming))
    live.data.copy_(incoming)


def _create_momentum(opt: torch.optim.Optimizer) -> None:
    """SGD's momentum buffers, zero, as its first step would create them
    (``0 * momentum + g == g`` bitwise, without dampening)."""
    if not isinstance(opt, torch.optim.SGD):
        return
    for group in opt.param_groups:
        if group["momentum"] != 0 and group["dampening"] == 0:
            for p in group["params"]:
                opt.state[p].setdefault("momentum_buffer", torch.zeros_like(p))


def _tensor_pairs(live: Dict[Any, Dict[str, Any]],
                  incoming: Dict[Any, Dict[str, Any]]) -> Optional[List[Tuple[torch.Tensor, Any]]]:
    """(live, incoming) tensor pairs of two optimizer states of one tree,
    or None where the trees differ."""
    if live.keys() != incoming.keys():
        return None
    pairs = []
    for i, st in incoming.items():
        if live[i].keys() != st.keys():
            return None
        for k, v in st.items():
            if not (isinstance(live[i][k], torch.Tensor) and isinstance(v, torch.Tensor)):
                return None
            pairs.append((live[i][k], v))
    return pairs


def _load_optimizer(opt: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    """Load ``sd`` into ``opt``: its tensors copied into the live state's
    where the trees align (``load_state_dict`` would replace them)."""
    pairs = _tensor_pairs(opt.state_dict()["state"], sd["state"])
    if pairs is None:
        opt.load_state_dict(sd)
        return
    for live, got in pairs:
        _copy_into(live, got)
    for group, incoming in zip(opt.param_groups, sd["param_groups"]):
        group.update({k: v for k, v in incoming.items() if k != "params"})


class LocalSGD:
    """Parameter-averaging LocalSGD (reference ``local_sgd.py:85-188``)::

        local_sgd = LocalSGD(manager, dict(model.named_parameters()), sync_every=8)
        for batch in data:
            ...; inner_optimizer.step()
            local_sgd.step(dict(model.named_parameters()))
    """

    def __init__(
        self,
        manager: Any,
        params: Any,
        sync_every: int,
        get_params: Optional[Callable[[], Any]] = None,
    ) -> None:
        if sync_every < 1:
            raise ValueError("sync_every must be at least 1")
        self._manager = manager
        # TORCHFT_SYNC_EVERY > 0 beats the constructor's argument
        env_sync = knobs.env_int("TORCHFT_SYNC_EVERY", 0)
        self._sync_every = env_sync if env_sync > 0 else sync_every
        self._arg_sync_every = self._sync_every
        self._local_step = 0
        # the policy plane retargets the cadence live at the Manager's safe
        # point (a Manager without the plane, or a stub, has no adjusters)
        register = getattr(manager, "register_policy_adjuster", None)
        if register is not None:
            register("TORCHFT_SYNC_EVERY", self._policy_set_sync_every)
        # re-reads the caller's tree after a sync-quorum heal (an async
        # quorum heal is non-participating, so nothing stale is averaged)
        self._get_params = get_params
        self._backup = [leaf.detach().clone() for leaf in _flatten(params)]
        manager.register_state_dict_fn("LocalSGD", self._load_state, self._save_state)

    def _save_state(self) -> Dict[str, Any]:
        return {"backup": list(self._backup)}

    def _load_state(self, sd: Dict[str, Any]) -> None:
        incoming, _treedef = bucketing.tree_flatten(sd["backup"])
        for live, got in zip(self._backup, incoming):
            _copy_into(live, got)

    @property
    def sync_every(self) -> int:
        return self._sync_every

    def set_sync_every(self, sync_every: int) -> None:
        """Retarget the cadence; a shorter one syncs at the next step that
        has crossed it."""
        if sync_every < 1:
            raise ValueError("sync_every must be at least 1")
        self._sync_every = sync_every

    def _policy_set_sync_every(self, value: Optional[str]) -> None:
        if value is None:
            self.set_sync_every(self._arg_sync_every)
        else:
            self.set_sync_every(max(1, int(value)))

    def step(self, params: Any) -> Any:
        """Count an inner step; on the sync boundary average the parameters
        across replica groups, in place. Returns the tree to continue with."""
        self._local_step += 1
        if self._local_step < self._sync_every:
            return params
        self._local_step = 0
        return self._sync(params)

    @torch.no_grad()
    def _sync(self, params: Any) -> Any:
        self._manager.start_quorum()
        if self._manager.last_quorum_healed():
            if self._get_params is not None:
                params = self._get_params()
            else:
                # the registered load fn healed the backup (a peer's last
                # synced parameters): average that, not the stale locals
                logger.warning("LocalSGD: healed without get_params; averaging the "
                               "recovered backup instead of the stale local params")
                for leaf, b in zip(_flatten(params), self._backup):
                    leaf.copy_(b)
        leaves = _flatten(params)
        averaged = self._manager.allreduce(params, reduce_op=ReduceOp.AVG).get_future().wait()
        if self._manager.should_commit():
            for leaf, b, avg in zip(leaves, self._backup, _flatten(averaged)):
                b.copy_(avg)
                leaf.copy_(avg)
        else:
            logger.warning("LocalSGD commit failed; restoring last synced params")
            for leaf, b in zip(leaves, self._backup):
                leaf.copy_(b)
        return params


def partition_fragments(leaves: Sequence[Any], num_fragments: int) -> List[List[int]]:
    """Size-balanced greedy partition of leaf indices into fragments (by
    bytes), the reference's over the port's ``split_chunks``."""
    sizes = [
        leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
        else int(np.asarray(leaf).nbytes)
        for leaf in leaves
    ]
    frags = [sorted(c) for c in split_chunks(sizes, num_fragments)]
    return [f for f in frags if f]


class _Fragment:
    """One fragment: its global copy, its outer optimizer and its in-flight
    allreduce (reference ``_Fragment``, ``local_sgd.py:216-438``)."""

    def __init__(
        self,
        manager: Any,
        fragment_id: int,
        leaf_indices: List[int],
        leaves: List[torch.Tensor],
        outer_optimizer: OuterOptimizer,
        fragment_update_alpha: float,
        should_quantize: bool,
        use_bucketization: bool = False,
        bucket_cap_bytes: int = bucketing.DEFAULT_BUCKET_CAP_BYTES,
    ) -> None:
        self._manager = manager
        self._id = fragment_id
        self.leaf_indices = leaf_indices
        self._alpha = fragment_update_alpha
        self._should_quantize = should_quantize
        self._use_bucketization = use_bucketization
        self._bucket_cap_bytes = bucket_cap_bytes
        self._bucket_plan: Optional[bucketing.BucketPlan] = None
        # private copies on the leaves' device: the inner steps mutate the
        # leaves in place
        self.original: List[torch.Tensor] = [leaves[i].detach().clone() for i in leaf_indices]
        self.outer_optimizer = outer_optimizer(self.original)
        _create_momentum(self.outer_optimizer)
        self._work: Optional[Work] = None
        self._issued_at = 0.0
        self._done_at: Optional[float] = None
        # the last sync's seconds from issue to the allreduce's completion,
        # and of them the seconds perform_sync waited
        self.last_allreduce_s: Optional[float] = None
        self.last_wait_s: Optional[float] = None
        manager.register_state_dict_fn(
            f"StreamingDiLoCoFragment_{fragment_id}", self._load_state, self._save_state
        )

    def _save_state(self) -> Dict[str, Any]:
        return {
            "original_parameters": list(self.original),
            "outer_optimizer": self.outer_optimizer.state_dict(),
        }

    def _load_state(self, sd: Dict[str, Any]) -> None:
        for live, got in zip(self.original, sd["original_parameters"]):
            _copy_into(live, got)
        _load_optimizer(self.outer_optimizer, sd["outer_optimizer"])

    def prepare_sync(self, leaves: List[torch.Tensor]) -> None:
        """Pseudogradient = global - local, then the averaging allreduce is
        issued (reference ``local_sgd.py:401-420``). The pseudogradients are
        tensors of their own: the next inner steps mutate the leaves while
        the allreduce stages them."""
        if self._work is not None:
            raise RuntimeError(f"fragment {self._id} already has an allreduce in flight")
        with torch.no_grad():
            pseudograds = [o - leaves[i].detach() for o, i in zip(self.original, self.leaf_indices)]
        self._done_at = None
        self._issued_at = time.perf_counter()
        # only the unquantized path is pre-bucketed: a quantized tree goes
        # to the Manager whole, which streams it as compressed buckets
        if self._use_bucketization and not self._should_quantize and len(pseudograds) > 1:
            self._bucket_plan = bucketing.build_plan(pseudograds, self._bucket_cap_bytes)
            flats, _pooled = bucketing.pack(pseudograds, self._bucket_plan)
            self._work = self._manager.allreduce(flats, should_quantize=self._should_quantize)
        else:
            self._bucket_plan = None
            self._work = self._manager.allreduce(pseudograds, should_quantize=self._should_quantize)
        self._work.get_future().add_done_callback(self._mark_done)

    def _mark_done(self, _fut: Any) -> None:
        self._done_at = time.perf_counter()

    @torch.no_grad()
    def perform_sync(self, leaves: List[torch.Tensor]) -> bool:
        """Wait for the allreduce, vote, and on commit take the outer step
        and merge, in place into ``leaves``; on a failed commit restore the
        global copy (reference ``local_sgd.py:422-475``). Returns the vote."""
        if self._work is None:
            raise RuntimeError(f"fragment {self._id}: perform_sync before prepare_sync")
        t0 = time.perf_counter()
        avg = self._work.get_future().wait()
        now = time.perf_counter()
        self.last_wait_s = now - t0
        self.last_allreduce_s = (self._done_at or now) - self._issued_at
        self._work = None
        if self._bucket_plan is not None:
            avg = bucketing.unpack(avg, self._bucket_plan)
            self._bucket_plan = None

        should_commit = self._manager.should_commit()
        if should_commit:
            for p, g in zip(self.original, avg):
                p.grad = g.to(device=p.device, dtype=p.dtype)
            self.outer_optimizer.step()
            for p in self.original:
                p.grad = None
            # merge: global + alpha * (local - global), the reference's lerp
            for g, i in zip(self.original, self.leaf_indices):
                local = leaves[i]
                local.copy_(g + self._alpha * (local - g))
        else:
            logger.warning(f"DiLoCo fragment {self._id}: commit failed; restoring global params")
            for g, i in zip(self.original, self.leaf_indices):
                leaves[i].copy_(g)
        return should_commit


class DiLoCo:
    """Streaming DiLoCo over a parameter pytree (reference
    ``local_sgd.py:441-694``)::

        params = dict(model.named_parameters())
        diloco = DiLoCo(manager, params,
                        lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True),
                        sync_every=20, num_fragments=2, get_params=lambda: params)
        for batch in data:
            ...; inner_optimizer.step()
            diloco.step(params)
    """

    def __init__(
        self,
        manager: Any,
        params: Any,
        outer_optimizer: OuterOptimizer,
        sync_every: int,
        num_fragments: int = 1,
        fragment_partition: Optional[List[List[int]]] = None,
        fragment_sync_delay: int = 0,
        fragment_update_alpha: float = 0.0,
        should_quantize: bool = False,
        use_bucketization: Optional[bool] = None,
        bucket_cap_mb: Optional[int] = None,
        get_params: Optional[Callable[[], Any]] = None,
    ) -> None:
        # the env var forces bucketization on, never off (reference
        # local_sgd.py:476-483)
        use_bucketization = knobs.env_bool("TORCHFT_USE_BUCKETIZATION") or bool(use_bucketization)
        # > 0 replaces the constructor's total cadence, validated below
        env_sync = knobs.env_int("TORCHFT_SYNC_EVERY", 0)
        if env_sync > 0:
            sync_every = env_sync
        bucket_cap_bytes = (
            bucket_cap_mb * 1024 * 1024 if bucket_cap_mb is not None
            else bucketing.DEFAULT_BUCKET_CAP_BYTES
        )

        if manager._use_async_quorum:
            raise ValueError(
                "DiLoCo requires synchronous quorum: construct the Manager "
                "with use_async_quorum=False"
            )
        leaves = _flatten(params)
        if fragment_partition is None:
            fragment_partition = partition_fragments(leaves, num_fragments)
        num_fragments = len(fragment_partition)
        if sync_every < num_fragments:
            raise ValueError("only 1 fragment can be synchronized at a time")
        if sync_every % num_fragments != 0:
            raise ValueError("sync_every must be divisible by num_fragments")
        # per-fragment cycle length
        self._sync_every = sync_every // num_fragments
        if fragment_sync_delay >= self._sync_every:
            raise ValueError("fragment must sync before it is reduced again")
        if not 0.0 <= fragment_update_alpha <= 1.0:
            raise ValueError("fragment_update_alpha must be in [0, 1]")

        self._manager = manager
        self._local_step = 0
        self._delay = fragment_sync_delay
        # re-reads the caller's tree after a sync-quorum heal: the leaves
        # passed to step() before start_quorum are stale then
        self._get_params = get_params
        self._fragments = [
            _Fragment(
                manager, i, idxs, leaves, outer_optimizer, fragment_update_alpha,
                should_quantize, use_bucketization=use_bucketization,
                bucket_cap_bytes=bucket_cap_bytes,
            )
            for i, idxs in enumerate(fragment_partition)
        ]
        self._arg_sync_every = self._sync_every
        self._pending_sync_every: Optional[int] = None
        # what the last step() did: ("prepare" | "perform", fragment) pairs
        self.last_step_syncs: List[Tuple[str, int]] = []
        # the policy plane's retarget, queued to the next cycle boundary
        # (_policy_set_sync_every)
        register = getattr(manager, "register_policy_adjuster", None)
        if register is not None:
            register("TORCHFT_SYNC_EVERY", self._policy_set_sync_every)

    @property
    def sync_every(self) -> int:
        """Per-fragment cycle length in force."""
        return self._sync_every

    @property
    def fragments(self) -> List[_Fragment]:
        return self._fragments

    def state_tensors(self) -> List[torch.Tensor]:
        """The live tensors of every fragment's state, in order: its globals,
        then its outer optimizer's state tensors."""
        out: List[torch.Tensor] = []
        for frag in self._fragments:
            out.extend(frag.original)
            for st in frag.outer_optimizer.state_dict()["state"].values():
                out.extend(v for v in st.values() if isinstance(v, torch.Tensor))
        return out

    def set_sync_every(self, sync_every: int) -> None:
        """Queue a retarget of the total cadence, validated as the
        constructor's; it applies at the next cycle boundary, so an
        in-flight prepare/perform pair is never split."""
        n = len(self._fragments)
        if sync_every < n or sync_every % n != 0:
            raise ValueError("sync_every must be a positive multiple of num_fragments")
        per = sync_every // n
        if self._delay >= per:
            raise ValueError("fragment must sync before it is reduced again")
        self._pending_sync_every = per

    def _policy_set_sync_every(self, value: Optional[str]) -> None:
        if value is None:
            self._pending_sync_every = self._arg_sync_every
            return
        # advisory: clamped into the legal range
        n = len(self._fragments)
        self._pending_sync_every = max(int(value) // n, self._delay + 1, 1)

    def _current_fragment(self) -> int:
        # every replica picks the fragment from the shared manager step, so
        # none sends another fragment than its peers
        return self._manager.current_step() % len(self._fragments)

    def step(self, params: Any) -> Any:
        """Advance one inner step; syncs a fragment on its boundaries, in
        place. Returns the tree to continue with (after a heal, the one
        ``get_params`` gives)."""
        if self._local_step == 0 and self._pending_sync_every is not None:
            self._sync_every = self._pending_sync_every
            self._pending_sync_every = None
        self._local_step += 1
        self.last_step_syncs = []
        leaves = _flatten(params)

        if self._local_step == self._sync_every - self._delay:
            # prepare: the allreduce overlaps the next `delay` inner steps
            self._manager.start_quorum()
            if self._manager.last_quorum_healed():
                if self._get_params is not None:
                    # pseudogradient = global - healed local, as the
                    # reference's in-place module heal gives
                    params = self._get_params()
                    leaves = _flatten(params)
                else:
                    # no drift of our own: local := the healed globals
                    # (a zero pseudogradient, conservative but never corrupting)
                    logger.warning("DiLoCo: healed without get_params; contributing zero "
                                   "pseudogradient this cycle")
                    with torch.no_grad():
                        for frag in self._fragments:
                            for g, i in zip(frag.original, frag.leaf_indices):
                                leaves[i].copy_(g)
            frag = self._current_fragment()
            logger.info(f"DiLoCo: preparing fragment={frag} step={self._local_step}")
            self._fragments[frag].prepare_sync(leaves)
            self.last_step_syncs.append(("prepare", frag))

        if self._local_step == self._sync_every:
            frag = self._current_fragment()
            logger.info(f"DiLoCo: syncing fragment={frag} "
                        f"manager_step={self._manager.current_step()}")
            self._fragments[frag].perform_sync(leaves)
            self.last_step_syncs.append(("perform", frag))
            self._local_step = 0
        return params

    def flush(self, params: Any) -> Any:
        """Complete any in-flight fragment sync: wait for its allreduce,
        vote, outer-step. Call before a trainer stops between a prepare and
        its perform (``fragment_sync_delay > 0``), or its peers wait on a
        vote this replica never casts. A no-op when nothing is in flight."""
        pending = [f for f in self._fragments if f._work is not None]
        if not pending:
            return params
        leaves = _flatten(params)
        for frag in pending:
            logger.info(f"DiLoCo: flushing in-flight sync of fragment {frag._id}")
            frag.perform_sync(leaves)
        self._local_step = 0
        return params
