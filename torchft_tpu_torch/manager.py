"""Manager: the per-worker fault-tolerance state machine.

Counterpart of ``torchft_tpu/manager.py``'s main path: the quorum
lifecycle on a one-thread executor (``start_quorum``, ``:767``; async body
``:1039``), process-group reconfiguration per quorum, live healing over the
checkpoint transport (``:1177-1246``, ``_recv_checkpoint`` ``:1397``), the
managed allreduce (``:1679``) with errors swallowed into a zeros result,
and the two-phase commit (``should_commit``, ``:3202``).

Replica groups here are single-rank (each replica group is one worker,
the leader of its own store and manager server) and the quorum is always
async: a healing replica sits its first step out. The reference's
multi-rank groups, synchronous quorum and ``max_retries`` are not ported.

The allreduce here is the reference's SERIAL path (the path its Manager
takes with ``stream_buckets=False``): the whole tree is one collective
staged on one ordered worker thread, fp8-quantized through
``collectives.allreduce_quantized`` when asked. Tensors on a CUDA device
take the device engine (the hand-written fp8 kernels); a non-participant
contributes device zeros. The streamed bucket pipeline, the policy,
degrade, redundancy, health and serving planes are not ported yet.
"""

from __future__ import annotations

import logging
import os
import socket as _socket
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from torchft_tpu_torch.checkpointing import CheckpointTransport, HTTPTransport, RWLock
from torchft_tpu_torch.coordination import (
    KvStoreServer,
    ManagerClient,
    ManagerServer,
)
from torchft_tpu_torch.futures import arm_deadline
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.work import DummyWork, Future, FutureWork, Work

logger = logging.getLogger(__name__)

__all__ = ["Manager", "ExceptionWithTraceback"]

LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"
# every replica group is one worker: rank 0 of a group of 1
_GROUP_RANK = 0
_CONNECT_TIMEOUT_S = 10.0
_HEARTBEAT_INTERVAL_S = 0.1


def _to_seconds(t: "float | timedelta") -> float:
    return t.total_seconds() if isinstance(t, timedelta) else float(t)


class ExceptionWithTraceback(Exception):
    def __init__(self, e: Exception) -> None:
        self.original_exception = e
        self.stack_trace = traceback.format_exc()
        super().__init__(f"{e}\n{self.stack_trace}")


def _is_float_leaf(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _wire_leaf(x: Any) -> np.ndarray:
    """Host copy of a leaf for the non-quantized wire. bf16 has no numpy
    dtype, so it rides as f32 and is cast back when the result lands."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(x)


class Manager:
    """Fault-tolerance manager for one worker of one replica group::

        manager = Manager(pg=ProcessGroupHost(), load_state_dict=load_fn,
                          state_dict=state_fn, min_replica_size=1)
        for batch in data:
            manager.start_quorum()
            grads = ...                      # forward + backward
            avg = manager.allreduce(grads, should_quantize=True).get_future().wait()
            if manager.should_commit():
                apply(avg)
    """

    def __init__(
        self,
        pg: ProcessGroup,
        load_state_dict: Optional[Callable[[Any], None]],
        state_dict: Optional[Callable[[], Any]],
        min_replica_size: int,
        timeout: "float | timedelta" = 60.0,
        quorum_timeout: "float | timedelta | None" = None,
        replica_id: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        init_sync: bool = True,
        hostname: str = "",
    ) -> None:
        self._pg = pg
        self._min_replica_size = min_replica_size
        self._timeout = _to_seconds(timeout)
        self._quorum_timeout = (
            _to_seconds(quorum_timeout) if quorum_timeout is not None else self._timeout
        )
        self._init_sync = init_sync

        self._state_dict_lock = RWLock(timeout=self._timeout)
        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}
        if state_dict is not None and load_state_dict is not None:
            self.register_state_dict_fn("default", load_state_dict, state_dict)

        hostname = hostname or _socket.gethostname()
        self._checkpoint_transport: CheckpointTransport = HTTPTransport(
            timeout=self._timeout, hostname=hostname
        )

        # the group's only rank leads it: it owns the rendezvous store and
        # the manager server
        self._store = KvStoreServer("0.0.0.0:0")
        store_addr = f"{hostname}:{self._store.port}"
        if lighthouse_addr is None:
            lighthouse_addr = os.environ[LIGHTHOUSE_ENV]
        self._replica_id = f"{replica_id or 'replica'}:{uuid.uuid4()}"
        self._manager = ManagerServer(
            replica_id=self._replica_id,
            lighthouse_addr=lighthouse_addr,
            hostname=hostname,
            bind="0.0.0.0:0",
            store_addr=store_addr,
            world_size=1,
            heartbeat_interval=_HEARTBEAT_INTERVAL_S,
            connect_timeout=_CONNECT_TIMEOUT_S,
        )
        manager_addr = self._manager.address()
        self._client = ManagerClient(manager_addr, connect_timeout=_CONNECT_TIMEOUT_S)
        # the commit vote rides its own client: the quorum thread's RPC is
        # in flight exactly when the main thread votes
        self._vote_client = ManagerClient(
            manager_addr, connect_timeout=_CONNECT_TIMEOUT_S
        )

        self._step = 0
        self._quorum_id = -1
        self._batches_committed = 0
        self._commit_failures = 0
        self._errored: Optional[ExceptionWithTraceback] = None
        self._metrics_lock = threading.Lock()
        self._metrics: Dict[str, int] = {
            "quorums": 0,
            "reconfigures": 0,
            "heals": 0,
            "commits": 0,
            "commit_failures": 0,
            "allreduces": 0,
            "errors": 0,
        }
        self._timings: Dict[str, float] = {}
        self._healing = False
        self._last_quorum_healed = False
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._participating_replica_rank: Optional[int] = None
        self._participating_replica_world_size = 0

        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torchft_quorum")
        # one ordered worker stages every allreduce: collectives start in
        # caller order on every replica (the host wire matches by arrival)
        self._staging_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_stage"
        )
        self._quorum_future: Optional[Any] = None

    def _log(self, level: int, msg: str) -> None:
        logger.log(level, f"[{self._replica_id} step {self._step}] {msg}")

    # ------------------------------------------------------------- state fns
    def register_state_dict_fn(
        self, key: str, load_fn: Callable[[Any], None], value_fn: Callable[[], Any]
    ) -> None:
        """Register a named (load, save) pair included in live recovery."""
        with self._state_dict_lock.w_lock():
            self._load_state_dict_fns[key] = load_fn
            self._user_state_dicts[key] = value_fn

    # --------------------------------------------------------------- quorum
    def start_quorum(self) -> None:
        """Start computing a new quorum (on the quorum thread) and ready the
        manager for a new step. Call before the forward pass."""
        if self._quorum_future is not None:
            self._quorum_future.result()
        self._errored = None
        self._healing = False
        self._last_quorum_healed = False
        self._quorum_future = self._executor.submit(self._async_quorum)

    def wait_quorum(self) -> None:
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum first")
        self._quorum_future.result()

    def _async_quorum(self) -> None:
        try:
            quorum = self._client._quorum(
                group_rank=_GROUP_RANK,
                step=self._step,
                checkpoint_metadata=self._checkpoint_transport.metadata(),
                shrink_only=False,
                timeout=self._quorum_timeout,
                init_sync=self._init_sync,
                commit_failures=self._commit_failures,
            )
        except Exception as e:  # noqa: BLE001 - swallowed into the step's vote
            self._log(logging.ERROR, f"quorum RPC failed: {e}")
            self.report_error(e)
            return

        self._bump_metric("quorums")
        # async quorum: healing replicas sit this step out, so the
        # participating world is the max-step cohort
        self._participating_replica_rank = quorum.max_replica_rank
        self._participating_replica_world_size = quorum.max_world_size

        if quorum.quorum_id != self._quorum_id:
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}/{_GROUP_RANK}"
            )
            self._log(logging.INFO, f"reconfiguring for quorum_id={quorum.quorum_id}")
            try:
                self._bump_metric("reconfigures")
                self._pg.configure(
                    store_prefixed_addr,
                    quorum.replica_rank,
                    quorum.replica_world_size,
                    quorum_id=quorum.quorum_id,
                )
                self._checkpoint_transport.configure(
                    f"{quorum.store_address}/torchft/{quorum.quorum_id}"
                    f"/recovery/{_GROUP_RANK}",
                    quorum.replica_rank,
                    quorum.replica_world_size,
                    quorum_id=quorum.quorum_id,
                )
                # recorded only after both configures succeed: on failure
                # the vote fails, the next quorum carries commit_failures>0
                # and the lighthouse bumps the id for EVERY replica
                self._quorum_id = quorum.quorum_id
            except Exception as e:  # noqa: BLE001 - swallowed into the vote
                self._log(logging.ERROR, f"pg configure failed: {e}")
                self.report_error(e)
                return

        try:
            if quorum.recover_dst_replica_ranks:
                self._log(
                    logging.INFO,
                    f"peers need recovery from us {quorum.recover_dst_replica_ranks}",
                )
                t0 = time.perf_counter()
                self._checkpoint_transport.send_checkpoint(
                    dst_ranks=quorum.recover_dst_replica_ranks,
                    step=quorum.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout,
                )
                self._record_timing("heal_send_s", time.perf_counter() - t0)
            if quorum.heal:
                self._healing = True
                t0 = time.perf_counter()
                self._pending_state_dict = self._recv_checkpoint(quorum)
                self._record_timing("heal_recv_s", time.perf_counter() - t0)
                # ft step/batches restore now; user state is applied from
                # the main thread when safe
                self.load_state_dict(self._pending_state_dict["torchft"])
                self._step = quorum.max_step
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._log(logging.ERROR, f"recovery failed: {e}")
            self.report_error(e)

    def _recv_checkpoint(self, quorum: Any) -> Dict[str, Any]:
        self._log(
            logging.INFO,
            f"healing from {quorum.recover_src_manager_address} step {quorum.max_step}",
        )
        metadata = ManagerClient(
            quorum.recover_src_manager_address, connect_timeout=_CONNECT_TIMEOUT_S
        )._checkpoint_metadata(_GROUP_RANK, timeout=self._timeout)
        return self._checkpoint_transport.recv_checkpoint(
            src_rank=quorum.recover_src_replica_rank,
            metadata=metadata,
            step=quorum.max_step,
            timeout=self._timeout,
        )

    def _apply_pending_state_dict(self) -> None:
        self.wait_quorum()
        pending = self._pending_state_dict
        if pending is None:
            raise RuntimeError("checkpoint was not staged")
        self._log(logging.INFO, "applying pending state dict")
        with self._state_dict_lock.w_lock():
            user = pending["user"]
            for key, load_fn in self._load_state_dict_fns.items():
                if key in user:
                    load_fn(user[key])
            self._pending_state_dict = None
        self._last_quorum_healed = True
        self._bump_metric("heals")

    # ------------------------------------------------------------ allreduce
    def allreduce(
        self,
        values: Any,
        should_quantize: bool = False,
        reduce_op: ReduceOp = ReduceOp.AVG,
    ) -> Work:
        """Fault-tolerant allreduce over a pytree of tensors or arrays.

        Returns a Work whose future resolves to the reduced pytree, each leaf
        on its input's device with its input's dtype. On error the future
        resolves to a zeros pytree and the error is kept for
        ``should_commit``."""
        self._bump_metric("allreduces")
        leaves, treedef = pytree.tree_flatten(values)

        def place(orig: Any, reduced: Any) -> Any:
            if isinstance(orig, torch.Tensor):
                if not isinstance(reduced, torch.Tensor):
                    reduced = torch.from_numpy(np.ascontiguousarray(reduced))
                return reduced.to(device=orig.device, dtype=orig.dtype)
            if isinstance(reduced, torch.Tensor):
                reduced = reduced.cpu().numpy()
            return np.asarray(reduced)

        def rebuild(reduced: List[Any]) -> Any:
            return pytree.tree_unflatten(
                [place(o, r) for o, r in zip(leaves, reduced)], treedef
            )

        def zeros() -> Any:
            return pytree.tree_unflatten([_zeros_like(l) for l in leaves], treedef)

        if self.errored():
            return DummyWork(zeros())
        self.wait_quorum()
        if self.errored():
            return DummyWork(zeros())
        num_participants = self.num_participants()

        pg_reduce_op = reduce_op
        if reduce_op == ReduceOp.AVG:
            if not all(_is_float_leaf(l) for l in leaves):
                raise ValueError("AVG allreduce requires floating point leaves")
            pg_reduce_op = ReduceOp.SUM

        def normalize(f: Future) -> Any:
            reduced = f.value()
            if reduce_op == ReduceOp.AVG and num_participants > 0:
                reduced = [
                    (r / num_participants).to(r.dtype) if isinstance(r, torch.Tensor)
                    else (r / num_participants).astype(r.dtype)
                    for r in reduced
                ]
            return rebuild(reduced)

        try:
            # capture on the caller thread: the staging thread reads these
            # after allreduce() returns, when the caller may already be
            # mutating its gradients. Non-participants contribute zeros
            # built from shapes alone.
            if self.is_participating():
                capture = [
                    l.detach().clone() if isinstance(l, torch.Tensor)
                    else np.array(l, copy=True)
                    for l in leaves
                ]
            else:
                capture = [_zeros_like(l) for l in leaves]
            staged_fut: Future = Future()
            stage_timeout = self._timeout

            def _stage_deadline() -> None:
                try:
                    staged_fut.set_exception(TimeoutError("allreduce staging timed out"))
                except RuntimeError:
                    pass

            def stage() -> None:
                # the deadline spans the whole staged op, wire included,
                # and starts when staging begins (not at submission)
                cancel = arm_deadline(_stage_deadline, stage_timeout)
                staged_fut.add_done_callback(lambda _f: cancel())
                try:
                    if should_quantize:
                        from torchft_tpu_torch.collectives import allreduce_quantized

                        w = allreduce_quantized(capture, pg_reduce_op, self._pg)
                        staged_fut.set_result(w.get_future().wait(stage_timeout))
                        return
                    w = self._pg.allreduce([_wire_leaf(l) for l in capture], pg_reduce_op)

                    def _xfer(f: Future) -> None:
                        try:
                            exc = f.exception()
                            if exc is not None:
                                staged_fut.set_exception(exc)
                            else:
                                staged_fut.set_result(f.value())
                        except RuntimeError:
                            pass

                    w.get_future().add_done_callback(_xfer)
                except Exception as e:  # noqa: BLE001 - resolves the op
                    try:
                        staged_fut.set_exception(e)
                    except RuntimeError:
                        pass

            self._staging_executor.submit(stage)
            fut = self.wrap_future(staged_fut.then(normalize), zeros)
            return FutureWork(fut)
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._log(logging.ERROR, f"allreduce failed: {e}")
            self.report_error(e)
            return DummyWork(zeros())

    # ------------------------------------------------------------- errors
    def report_error(self, e: Exception) -> None:
        """Mark the step as corrupt: it is discarded at should_commit and
        the PG reconfigured at the next quorum."""
        with self._metrics_lock:
            if self._errored is None:
                self._metrics["errors"] += 1
            self._errored = ExceptionWithTraceback(e)

    def errored(self) -> Optional[ExceptionWithTraceback]:
        return self._errored

    def wrap_future(self, fut: Future, default: Any) -> Future:
        """Swallow errors of ``fut`` into ``default`` (a value, or a zero-arg
        factory called only on the error path), reporting them. The
        deadline is the caller's (the allreduce arms one when staging
        begins)."""

        def callback(f: Future) -> Any:
            try:
                return f.value()
            except Exception as e:  # noqa: BLE001 - the swallow contract
                self._log(logging.ERROR, f"future failed, step will be discarded: {e}")
                self.report_error(e)
                return default() if callable(default) else default

        return fut.then(callback)

    # ------------------------------------------------------------- commit
    def should_commit(self) -> bool:
        """Two-phase commit vote across the replica group: True iff every
        rank of this group is healthy and enough replicas participate."""
        if self._quorum_future is not None:
            try:
                self._quorum_future.result()
            except Exception as e:  # noqa: BLE001 - swallowed into the vote
                self.report_error(e)
        if (err := self._pg.errored()) is not None:
            self.report_error(err)
        if self._healing and self._pending_state_dict is not None:
            self._apply_pending_state_dict()
        self._healing = False

        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self._errored is None
        if not local_should_commit:
            self._log(
                logging.WARNING,
                f"voting False: participants={self.num_participants()} "
                f"min={self._min_replica_size} errored={self._errored!r}",
            )
        should_commit = self._vote_client.should_commit(
            _GROUP_RANK,
            self._step,
            local_should_commit,
            timeout=self._timeout,
        )
        self._checkpoint_transport.disallow_checkpoint()
        if should_commit:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            self._bump_metric("commits")
        else:
            self._commit_failures += 1
            self._bump_metric("commit_failures")
        return should_commit

    # -------------------------------------------------------- introspection
    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def _manager_state_dict(self) -> Dict[str, Any]:
        if not self._user_state_dicts:
            raise RuntimeError("user state_dict is not registered")
        return {"user": self.user_state_dict(), "torchft": self.state_dict()}

    def user_state_dict(self) -> Dict[str, Any]:
        with self._state_dict_lock.r_lock():
            return {key: fn() for key, fn in self._user_state_dicts.items()}

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def num_participants(self) -> int:
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        return self._participating_replica_world_size

    def is_participating(self) -> bool:
        if self._participating_replica_rank is None:
            return False
        return not self._healing

    def last_quorum_healed(self) -> bool:
        """True iff the most recent quorum live-healed this replica."""
        return self._last_quorum_healed

    def _bump_metric(self, name: str) -> None:
        with self._metrics_lock:
            self._metrics[name] += 1

    def metrics(self) -> Dict[str, int]:
        """Lifetime counters: quorums, reconfigures, heals, commits,
        commit_failures, allreduces, errors."""
        with self._metrics_lock:
            return dict(self._metrics)

    def _record_timing(self, name: str, value: float) -> None:
        with self._metrics_lock:
            self._timings[name] = value

    def timings(self) -> Dict[str, float]:
        """Wall-clock seconds of the last heal send/receive."""
        with self._metrics_lock:
            return dict(self._timings)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self, wait: bool = True) -> None:
        self._checkpoint_transport.shutdown(wait=wait)
        self._manager.shutdown()
        self._store.shutdown()
        self._executor.shutdown(wait=wait)
        self._staging_executor.shutdown(wait=wait, cancel_futures=not wait)
        self._pg.shutdown()


def _zeros_like(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros(np.shape(x), np.asarray(x).dtype)
