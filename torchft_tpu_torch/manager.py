"""Manager: the per-worker fault-tolerance state machine.

Counterpart of ``torchft_tpu/manager.py``'s main path: the quorum
lifecycle on a one-thread executor (``start_quorum``, ``:767``; async body
``:1039``), process-group reconfiguration per quorum, live healing over the
checkpoint transport (``:1177-1246``, ``_recv_checkpoint`` ``:1397``), the
managed allreduce (``:1679``, ``allreduce_streamed`` ``:1695``) with errors
swallowed into a zeros result, and the two-phase commit
(``should_commit``, ``:3202``).

A replica group is one worker or several (``group_world_size``, reference
``:230-232``, ``:348-389``): group rank 0 leads it, owning the rendezvous
store (unless ``store_addr`` names one) and the manager server, which
barriers the group's ranks at every quorum and ANDs their commit votes,
and publishes the server's address in the store as ``manager_addr``; every
other rank reads it there. Each rank quorums, votes, forms its
cross-group process group (store prefix ``.../torchft/{quorum_id}/{group
rank}``) and heals from the same group rank of a healthy group.

The quorum is async by default (``use_async_quorum``, ``:224``): it runs
on the quorum thread while the step computes, and a healing replica sits
its first step out.
With ``use_async_quorum=False`` (what DiLoCo needs) ``start_quorum`` waits
for the quorum and applies a heal there and then (``:767-842``), so the
healed replica takes part in the same step. The reference's
``max_retries`` and ``start_quorum``'s ``allow_heal`` / ``shrink_only`` /
``timeout`` are not ported.
The heal rides ``checkpoint_transport`` (``:233``, ``:308-315``): the
port's ``HTTPTransport`` by default, or a ``PGTransport`` over a recovery
process group of its own, which the Manager reconfigures with its PG at
every new quorum under the ``.../recovery/{group_rank}`` store prefix.

The allreduce takes the reference's host-plane paths. By default (as the
reference's) a multi-leaf tree STREAMS (``:1891-2200``): ``bucketing``
packs it into buckets of at most ``bucket_cap_bytes`` (1 GiB), and each
bucket is one collective, three stages deep: pack (the concatenation and,
when compressed, the coding, with error feedback), wire (the PG's dispatch
thread), unpack (decode, AVG divide, slice and land, on the unpack
worker), so bucket i+1 packs while bucket i is on the wire. Buckets ride
compressed (fp8 or int8, with per-bucket error-feedback residuals) when
``should_quantize`` is set or ``TORCHFT_COMPRESS`` asks; a bucket on the
card is coded there by the fp8 kernels and only its codes cross to the
host. Without streaming (``stream_buckets=False``), and for a single leaf,
the SERIAL path: one collective for the whole tree on one ordered staging
thread, fp8-quantized through ``collectives.allreduce_quantized`` when
asked (CUDA tensors take its device engine); an unquantized tree is
bucketed into that one collective. A non-participant contributes zeros and
never touches the residuals. The device-plane streaming branch (an XLA
process group), the policy, degrade, redundancy, health and serving
planes are not ported yet.

Knobs, each environment variable > constructor argument > default:
``TORCHFT_BUCKET_CAP_MB`` / ``bucket_cap_bytes`` (1 GiB; 0 disables
bucketing), ``TORCHFT_STREAM_BUCKETS`` / ``stream_buckets`` (on; "0",
"false", "no" or "off" turn it off), ``TORCHFT_COMPRESS`` / ``compress``
("off", "fp8" or "int8"; "off", and ``should_quantize`` picks fp8).
"""

from __future__ import annotations

import logging
import os
import socket as _socket
import threading
import time
import traceback
import uuid
import weakref
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from torchft_tpu_torch import bucketing
from torchft_tpu_torch.checkpointing import CheckpointTransport, HTTPTransport, RWLock
from torchft_tpu_torch.coordination import (
    KvClient,
    KvStoreServer,
    ManagerClient,
    ManagerServer,
)
from torchft_tpu_torch.futures import arm_deadline
from torchft_tpu_torch.ops.quantization import (
    compress_bucket,
    decompress_bucket,
    is_compressed_wire,
    resolve_compress_mode,
)
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.utils import true_divide
from torchft_tpu_torch.work import (
    DummyWork,
    Future,
    FutureWork,
    GradStream,
    Work,
    join_futures,
)

logger = logging.getLogger(__name__)

__all__ = ["Manager", "ExceptionWithTraceback"]

LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"
BUCKET_CAP_MB_ENV = "TORCHFT_BUCKET_CAP_MB"
STREAM_BUCKETS_ENV = "TORCHFT_STREAM_BUCKETS"
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


def _leaf_device(x: Any) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _place(orig: Any, reduced: Any) -> Any:
    """A reduced value landed as its original leaf: a tensor on the leaf's
    device in its dtype, or an ndarray for an array leaf."""
    if isinstance(orig, torch.Tensor):
        if not isinstance(reduced, torch.Tensor):
            reduced = torch.from_numpy(np.ascontiguousarray(reduced))
        return reduced.to(device=orig.device, dtype=orig.dtype)
    if isinstance(reduced, torch.Tensor):
        reduced = reduced.cpu().numpy()
    return np.asarray(reduced)


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
        use_async_quorum: bool = True,
        timeout: "float | timedelta" = 60.0,
        quorum_timeout: "float | timedelta | None" = None,
        replica_id: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        init_sync: bool = True,
        hostname: str = "",
        bucket_cap_bytes: Optional[int] = None,
        stream_buckets: Optional[bool] = None,
        compress: Optional[str] = None,
        checkpoint_transport: Optional[CheckpointTransport] = None,
        store_addr: Optional[str] = None,
        group_rank: int = 0,
        group_world_size: int = 1,
    ) -> None:
        if group_rank != 0 and store_addr is None:
            raise ValueError("a group rank other than 0 needs the leader's store_addr")
        self._pg = pg
        set_reroute = getattr(pg, "set_reroute_observer", None)
        if set_reroute is not None:
            set_reroute(self._on_collective_reroute)
        self._min_replica_size = min_replica_size
        # DiLoCo reads this attribute by name (local_sgd.py)
        self._use_async_quorum = use_async_quorum
        self._timeout = _to_seconds(timeout)
        self._quorum_timeout = (
            _to_seconds(quorum_timeout) if quorum_timeout is not None else self._timeout
        )
        self._init_sync = init_sync

        env_cap = os.environ.get(BUCKET_CAP_MB_ENV)
        if env_cap is not None:
            self._bucket_cap_bytes = int(float(env_cap) * 1024 * 1024)
        elif bucket_cap_bytes is not None:
            self._bucket_cap_bytes = int(bucket_cap_bytes)
        else:
            self._bucket_cap_bytes = bucketing.DEFAULT_BUCKET_CAP_BYTES
        env_stream = os.environ.get(STREAM_BUCKETS_ENV)
        if env_stream is not None:
            self._stream_buckets = env_stream.strip().lower() not in ("0", "false", "no", "off")
        elif stream_buckets is not None:
            self._stream_buckets = bool(stream_buckets)
        else:
            self._stream_buckets = True
        # raises on a bad value rather than training uncompressed silently
        self._compress = resolve_compress_mode(compress)
        # flat buffers: the EF residuals and the packing of array leaves
        self._buffer_pool = bucketing.BufferPool()
        # per-(plan, bucket) error-feedback residuals: what quantization
        # rounded away at one step is added back before the next step's
        # quantization; weakly keyed, they die with their plan
        self._ef_residuals: "weakref.WeakKeyDictionary[bucketing.BucketPlan, List[Any]]" = (
            weakref.WeakKeyDictionary()
        )
        self._ef_lock = threading.Lock()

        self._state_dict_lock = RWLock(timeout=self._timeout)
        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}
        if state_dict is not None and load_state_dict is not None:
            self.register_state_dict_fn("default", load_state_dict, state_dict)

        hostname = hostname or _socket.gethostname()
        if checkpoint_transport is None:
            # the heal URL uses the hostname the store and manager use
            checkpoint_transport = HTTPTransport(timeout=self._timeout, hostname=hostname)
        self._checkpoint_transport: CheckpointTransport = checkpoint_transport

        self._group_rank = group_rank
        self._store: Optional[KvStoreServer] = None
        self._manager: Optional[ManagerServer] = None
        if group_rank == 0:
            # the group's leader owns the rendezvous store (unless one is
            # named) and the manager server, and publishes its address for
            # the other ranks
            if store_addr is None:
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
                world_size=group_world_size,
                heartbeat_interval=_HEARTBEAT_INTERVAL_S,
                connect_timeout=_CONNECT_TIMEOUT_S,
            )
            manager_addr = self._manager.address()
            KvClient(store_addr, connect_timeout=_CONNECT_TIMEOUT_S).set(
                "manager_addr", manager_addr, timeout=self._timeout
            )
        else:
            manager_addr = KvClient(store_addr, connect_timeout=_CONNECT_TIMEOUT_S).get(
                "manager_addr", timeout=self._timeout
            ).decode()
            self._replica_id = replica_id or "replica"
        self._store_addr = store_addr
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
        # the streamed pipeline's third stage (decode, divide, slice, land)
        # runs here, off the PG's dispatch thread, so the next bucket's
        # wire starts at once
        self._unpack_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_unpack"
        )
        self._quorum_future: Optional[Any] = None

    def _log(self, level: int, msg: str) -> None:
        logger.log(level, f"[{self._replica_id}/{self._group_rank} step {self._step}] {msg}")

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
        manager for a new step. Call before the forward pass. Under the
        synchronous quorum it returns once the quorum is in, with a heal
        already applied (``last_quorum_healed()`` true); a failed recovery
        leaves the step's vote to fail."""
        if self._quorum_future is not None:
            self._quorum_future.result()
        self._errored = None
        self._healing = False
        self._last_quorum_healed = False
        self._quorum_future = self._executor.submit(self._async_quorum)
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing and self._pending_state_dict is not None:
                # the forward pass runs on the recovered state
                self._apply_pending_state_dict()
            # a failed recovery has reported its error: retry at the next quorum
            self._healing = False

    def wait_quorum(self) -> None:
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum first")
        self._quorum_future.result()

    def _async_quorum(self) -> None:
        try:
            quorum = self._client._quorum(
                group_rank=self._group_rank,
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
        # participating world is the max-step cohort; the sync quorum heals
        # first, so everyone counts
        if self._use_async_quorum:
            self._participating_replica_rank = quorum.max_replica_rank
            self._participating_replica_world_size = quorum.max_world_size
        else:
            self._participating_replica_rank = quorum.replica_rank
            self._participating_replica_world_size = quorum.replica_world_size

        if quorum.quorum_id != self._quorum_id:
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}/{self._group_rank}"
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
                    f"/recovery/{self._group_rank}",
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
                stream = self._checkpoint_transport.last_recv_timings()
                if stream is not None:
                    self._record_timing("heal_chunks", float(stream.num_chunks))
                    self._record_timing("heal_mb_per_s", stream.mb_per_s)
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
        )._checkpoint_metadata(self._group_rank, timeout=self._timeout)
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
        on its input's device with its input's dtype (dicts keyed in sorted
        order, as the reference's). On error the future resolves to a zeros
        pytree and the error is kept for ``should_commit``."""
        work, _stream = self._allreduce(values, should_quantize, reduce_op)
        return work

    def allreduce_streamed(
        self,
        values: Any,
        reduce_op: ReduceOp = ReduceOp.AVG,
        bucket_cap_bytes: Optional[int] = None,
        should_quantize: bool = False,
    ) -> GradStream:
        """``allreduce`` with per-bucket completion: the GradStream's
        ``ready(i)`` says when bucket i has landed and ``wait()`` returns
        the reduced pytree. ``bucket_cap_bytes`` overrides the Manager's cap
        for this call. A tree that does not stream (single leaf, bucketing
        or streaming off) gives a one-bucket stream."""
        work, stream = self._allreduce(
            values, should_quantize, reduce_op, bucket_cap_bytes=bucket_cap_bytes
        )
        if stream is None:
            fut = work.get_future()
            stream = GradStream([fut], fut)
        return stream

    def _allreduce(
        self,
        values: Any,
        should_quantize: bool = False,
        reduce_op: ReduceOp = ReduceOp.AVG,
        bucket_cap_bytes: Optional[int] = None,
    ) -> Tuple[Work, Optional[GradStream]]:
        """The engine behind allreduce and allreduce_streamed: ``(work,
        stream)``, the stream a GradStream when the op streamed."""
        self._bump_metric("allreduces")
        leaves, treedef = bucketing.tree_flatten(values)
        cap = self._bucket_cap_bytes if bucket_cap_bytes is None else int(bucket_cap_bytes)
        # the serial quantized path is never pre-bucketed: it flattens the
        # tree into one wire itself, and packing first would move its fp8
        # row boundaries; streamed, a quantized tree rides compressed buckets
        plan: Optional[bucketing.BucketPlan] = None
        if (not should_quantize or self._stream_buckets) and len(leaves) > 1 and cap > 0:
            try:
                plan = bucketing.plan_for(leaves, cap, treedef=treedef)
            except Exception:  # noqa: BLE001 - exotic leaves go unbucketed
                plan = None

        def rebuild(reduced: List[Any]) -> Any:
            return pytree.tree_unflatten(
                [_place(o, r) for o, r in zip(leaves, reduced)], treedef
            )

        def zeros() -> Any:
            return pytree.tree_unflatten([_zeros_like(l) for l in leaves], treedef)

        if self.errored():
            return DummyWork(zeros()), None
        self.wait_quorum()
        if self.errored():
            return DummyWork(zeros()), None
        num_participants = self.num_participants()

        pg_reduce_op = reduce_op
        if reduce_op == ReduceOp.AVG:
            if not all(_is_float_leaf(l) for l in leaves):
                raise ValueError("AVG allreduce requires floating point leaves")
            pg_reduce_op = ReduceOp.SUM

        def divide(x: Any) -> Any:
            if reduce_op == ReduceOp.AVG and num_participants > 0:
                return true_divide(x, num_participants)
            return x

        try:
            if plan is not None and self._stream_buckets:
                return self._allreduce_streaming(
                    leaves, treedef, plan, should_quantize, pg_reduce_op, divide, zeros
                )
            return FutureWork(self._allreduce_serial(
                leaves, plan, should_quantize, pg_reduce_op, divide, rebuild, zeros
            )), None
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._log(logging.ERROR, f"allreduce failed: {e}")
            self.report_error(e)
            return DummyWork(zeros()), None

    def _allreduce_serial(
        self,
        leaves: List[Any],
        plan: Optional[bucketing.BucketPlan],
        should_quantize: bool,
        pg_reduce_op: ReduceOp,
        divide: Callable[[Any], Any],
        rebuild: Callable[[List[Any]], Any],
        zeros: Callable[[], Any],
    ) -> Future:
        """One collective for the whole tree (its buckets, when ``plan``)
        on the ordered staging worker."""
        # capture on the caller thread: the staging thread reads these
        # after allreduce() returns, when the caller may already be
        # mutating its gradients. Non-participants contribute zeros.
        if plan is not None:
            if self.is_participating():
                capture, _pooled = bucketing.pack(leaves, plan)
            else:
                capture = [
                    torch.zeros(size, dtype=dtype, device=_leaf_device(leaves[g[0]]))
                    for g, size, dtype in zip(plan.groups, plan.sizes, plan.dtypes)
                ]
        elif self.is_participating():
            capture = [
                l.detach().clone() if isinstance(l, torch.Tensor) else np.array(l, copy=True)
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
            # the deadline spans the whole staged op, wire included, and
            # starts when staging begins (not at submission)
            cancel = arm_deadline(_stage_deadline, stage_timeout)
            staged_fut.add_done_callback(lambda _f: cancel())
            try:
                if should_quantize:
                    from torchft_tpu_torch.collectives import allreduce_quantized

                    w = allreduce_quantized(capture, pg_reduce_op, self._pg)
                    staged_fut.set_result(w.get_future().wait(stage_timeout))
                    return
                w = self._pg.allreduce(capture, pg_reduce_op)

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

        def normalize(f: Future) -> Any:
            reduced = [divide(r) for r in f.value()]
            if plan is not None:
                reduced = bucketing.unpack(reduced, plan)
            return rebuild(reduced)

        self._staging_executor.submit(stage)
        return self.wrap_future(staged_fut.then(normalize), zeros)

    def _allreduce_streaming(
        self,
        leaves: List[Any],
        treedef: Any,
        plan: bucketing.BucketPlan,
        should_quantize: bool,
        pg_reduce_op: ReduceOp,
        divide: Callable[[Any], Any],
        zeros: Callable[[], Any],
    ) -> Tuple[Work, GradStream]:
        """One collective per bucket, three stages each: pack (on the
        staging worker: the coding with error feedback, or the staging of
        the raw bucket), wire (the PG's dispatch thread), unpack (decode,
        divide, slice and land one bucket, on the unpack worker). Numerics
        are the serial path's per bucket."""
        n_buckets = len(plan)
        # per-bucket (start, end) perf_counter marks of each stage
        marks: List[Dict[str, Tuple[float, float]]] = [{} for _ in range(n_buckets)]
        bucket_futs: List[Future] = [Future() for _ in range(n_buckets)]
        devices = [_leaf_device(leaves[g[0]]) for g in plan.groups]
        final_fut: Future = Future()

        def _assemble(f: Future) -> Any:
            placed: Dict[int, Any] = {}
            for pairs in f.value():
                placed.update(pairs)
            return pytree.tree_unflatten([placed[i] for i in range(len(leaves))], treedef)

        def _feed_final(f: Future) -> None:
            try:
                value = f.value()
            except Exception as e:  # noqa: BLE001 - the join's failure
                try:
                    final_fut.set_exception(e)
                except RuntimeError:
                    pass
                return
            try:
                final_fut.set_result(value)
            except RuntimeError:  # the staging deadline fired first
                pass

        joined = join_futures(bucket_futs)
        # timings land before the result: a caller reads them after wait().
        # After a failure other buckets may still be adding marks: copies
        # (one C call each under the GIL) keep the reading safe.
        joined.add_done_callback(
            lambda _f: self._record_pipeline_timings([dict(m) for m in marks])
        )
        joined.then(_assemble).add_done_callback(_feed_final)

        def _land_bucket(i: int, flat: Any, pooled_buf: Optional[torch.Tensor]) -> None:
            try:
                t0 = time.perf_counter()
                if is_compressed_wire(flat):
                    # the codes carry the reduced SUM, decoded to the
                    # bucket's dtype before the divide, as the reference's
                    flat = decompress_bucket(flat)
                elif not isinstance(flat, torch.Tensor):
                    flat = torch.from_numpy(flat)
                flat = divide(flat.to(devices[i]))
                pairs = [
                    (idx, _place(leaves[idx], val))
                    for idx, val in bucketing.unpack_bucket(flat, plan, i)
                ]
                if devices[i].type == "cuda":
                    # the landed tensors are ready on any stream the caller
                    # reads them from
                    torch.cuda.current_stream(devices[i]).synchronize()
                marks[i]["unpack"] = (t0, time.perf_counter())
                if pooled_buf is not None:
                    self._buffer_pool.release(pooled_buf)
                bucket_futs[i].set_result(pairs)
            except Exception as e:  # noqa: BLE001 - fails the join
                try:
                    bucket_futs[i].set_exception(e)
                except RuntimeError:
                    pass

        participating = self.is_participating()
        if participating:
            capture, pooled = bucketing.pack(leaves, plan, pool=self._buffer_pool)
        else:
            capture, pooled = None, []
        pooled_ids = {id(b) for b in pooled}
        # the packs ran on the caller's stream; the staging worker's launches
        # and copies wait for them there
        packed = {}
        for dev in set(devices):
            if dev.type == "cuda":
                packed[dev] = torch.cuda.Event()
                packed[dev].record(torch.cuda.current_stream(dev))

        compress_mode = self._compress
        if should_quantize and compress_mode == "off":
            compress_mode = "fp8"
        bucket_modes = [
            compress_mode if dtype.is_floating_point else "off" for dtype in plan.dtypes
        ]
        # non-participants code their zero contribution too (the ring needs
        # the same wire geometry everywhere) but never touch the residuals
        ef_store = (
            self._bucket_residuals(plan)
            if participating and compress_mode != "off" else None
        )
        stage_timeout = self._timeout

        def _stage_deadline() -> None:
            try:
                final_fut.set_exception(TimeoutError("allreduce staging timed out"))
            except RuntimeError:
                pass

        def _wire_done(f: Future, i: int, t0w: float, pooled_buf: Any) -> None:
            # on the PG's dispatch thread: record and hand off at once
            marks[i]["wire"] = (t0w, time.perf_counter())
            try:
                flat = f.value()[0]
                self._unpack_executor.submit(_land_bucket, i, flat, pooled_buf)
            except Exception as e:  # noqa: BLE001 - the wire's or shutdown's
                try:
                    bucket_futs[i].set_exception(e)
                except RuntimeError:
                    pass

        def stage() -> None:
            cancel = arm_deadline(_stage_deadline, stage_timeout)
            final_fut.add_done_callback(lambda _f: cancel())
            try:
                for dev, ev in packed.items():
                    torch.cuda.current_stream(dev).wait_event(ev)
                for i in range(n_buckets):
                    t0 = time.perf_counter()
                    if capture is None:
                        flat = torch.zeros(plan.sizes[i], dtype=plan.dtypes[i], device=devices[i])
                        pooled_buf = None
                    else:
                        flat = capture[i]
                        pooled_buf = flat if id(flat) in pooled_ids else None
                    payload: Any = flat
                    if bucket_modes[i] != "off":
                        # coded inside the pack stage, so pack_s holds it
                        payload = self._compress_bucket_ef(
                            flat, bucket_modes[i], plan.dtypes[i], ef_store, i
                        )
                    w = self._pg.allreduce([payload], pg_reduce_op)
                    t1 = time.perf_counter()
                    marks[i]["pack"] = (t0, t1)
                    w.get_future().add_done_callback(
                        lambda f, i=i, t1=t1, pb=pooled_buf: _wire_done(f, i, t1, pb)
                    )
            except Exception as e:  # noqa: BLE001 - fails every bucket
                for bf in bucket_futs:
                    try:
                        bf.set_exception(e)
                    except RuntimeError:
                        pass

        self._staging_executor.submit(stage)
        wrapped = self.wrap_future(final_fut, zeros)
        return FutureWork(wrapped), GradStream(bucket_futs, wrapped)

    def _bucket_residuals(self, plan: bucketing.BucketPlan) -> List[Any]:
        """The per-bucket error-feedback residual slots of one plan (None
        until the bucket is first coded)."""
        with self._ef_lock:
            store = self._ef_residuals.get(plan)
            if store is None:
                store = [None] * len(plan)
                self._ef_residuals[plan] = store
            return store

    def _compress_bucket_ef(
        self,
        flat: torch.Tensor,
        mode: str,
        out_dtype: torch.dtype,
        store: Optional[List[Any]],
        i: int,
    ) -> Any:
        """Code one packed bucket for the wire with error feedback: the
        residual (what the coding rounded away at the last step) is added
        in f32 before coding, and replaced by this step's. ``store`` is None
        for a non-participant. On the staging worker only, so a plan's
        residuals never race. A CUDA bucket stays on the card: the add, the
        coding and the residual update run there."""
        resid = store[i] if store is not None else None
        work = flat + resid if resid is not None else flat.to(torch.float32)
        if store is not None and resid is None:
            resid = self._buffer_pool.acquire(work.numel(), torch.float32, work.device)
            store[i] = resid
        return compress_bucket(work, mode, dtype=out_dtype, residual=resid)

    def _on_collective_reroute(self, pair: tuple, attempt: int) -> None:
        """The compressed ring re-formed around a dead link mid-collective:
        a re-routed slow step, counted in timings()["collective_reroute"]."""
        with self._metrics_lock:
            self._timings["collective_reroute"] = self._timings.get("collective_reroute", 0.0) + 1
        self._log(logging.WARNING, f"collective re-routed around dead link {pair} (attempt {attempt})")

    def _record_pipeline_timings(self, marks: List[Dict[str, Tuple[float, float]]]) -> None:
        """Fold one streamed allreduce's stage marks into timings()."""
        stats = _pipeline_overlap_stats(marks)
        with self._metrics_lock:
            self._timings.update(stats)

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
            self._group_rank,
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

    def state_dict_template(self) -> Dict[str, Any]:
        """The live heal composite, as an in-place template for a transport:
        ``PGTransport(pg, state_dict_template=lambda:
        manager.state_dict_template())`` (late-bound: the transport is made
        before the Manager). Sender and receiver build this tree from their
        registered state fns, so its leaves align by index."""
        return self._manager_state_dict()

    def user_state_dict(self) -> Dict[str, Any]:
        with self._state_dict_lock.r_lock():
            return {key: fn() for key, fn in self._user_state_dicts.items()}

    def current_step(self) -> int:
        return self._step

    @property
    def store_addr(self) -> str:
        """The replica group's rendezvous store (its leader's), which the
        other group ranks take as ``store_addr``."""
        return self._store_addr

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
        if self._healing:
            # start_quorum never leaves a sync-quorum replica healing
            assert self._use_async_quorum
            return False
        return True

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
        """Wall-clock seconds of the last heal send/receive
        (``heal_send_s``, ``heal_recv_s``), the chunks and MiB/s of the
        last streamed receive (``heal_chunks``, ``heal_mb_per_s``) and,
        once an allreduce has streamed, of its stages summed over buckets
        (``allreduce_pack_s``, ``allreduce_wire_s``, ``allreduce_unpack_s``),
        its bucket count (``allreduce_buckets``) and ``overlap_efficiency``:
        the share of wire time that ran while another bucket was in some
        stage. Also the lifetime count of compressed-ring re-routes
        (``collective_reroute``) once one has happened."""
        with self._metrics_lock:
            return dict(self._timings)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self, wait: bool = True) -> None:
        self._checkpoint_transport.shutdown(wait=wait)
        if self._manager is not None:
            self._manager.shutdown()
        if self._store is not None:
            self._store.shutdown()
        self._executor.shutdown(wait=wait)
        self._staging_executor.shutdown(wait=wait, cancel_futures=not wait)
        self._unpack_executor.shutdown(wait=wait, cancel_futures=not wait)
        self._pg.shutdown()


def _zeros_like(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros(np.shape(x), np.asarray(x).dtype)


def _covered_seconds(start: float, end: float, intervals: List[Tuple[float, float]]) -> float:
    """Length of ``[start, end]`` covered by the union of ``intervals``."""
    if end <= start:
        return 0.0
    clipped = sorted((max(start, a), min(end, b)) for a, b in intervals if b > start and a < end)
    total = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for a, b in clipped:
        if cur_s is None:
            cur_s, cur_e = a, b
        elif a <= cur_e:
            cur_e = max(cur_e, b)
        else:
            total += cur_e - cur_s
            cur_s, cur_e = a, b
    if cur_s is not None:
        total += cur_e - cur_s
    return total


def _pipeline_overlap_stats(marks: List[Dict[str, Tuple[float, float]]]) -> Dict[str, float]:
    """Sums of one streamed allreduce's stage intervals (``marks[i]`` maps
    "pack", "wire", "unpack" to (start, end); a stage a bucket never reached
    is absent) and ``overlap_efficiency`` = sum_i |wire_i intersected with
    the union of the other buckets' stages| / sum_i |wire_i|: the share of
    wire time hidden behind other buckets (0 for one bucket)."""
    sums = {
        stage: sum(e - s for m in marks if stage in m for s, e in [m[stage]])
        for stage in ("pack", "wire", "unpack")
    }
    hidden = 0.0
    for i, m in enumerate(marks):
        if "wire" not in m:
            continue
        others = [iv for j, mj in enumerate(marks) if j != i for iv in mj.values()]
        hidden += _covered_seconds(*m["wire"], others)
    return {
        "allreduce_pack_s": sums["pack"],
        "allreduce_wire_s": sums["wire"],
        "allreduce_unpack_s": sums["unpack"],
        "allreduce_buckets": float(len(marks)),
        "overlap_efficiency": hidden / sums["wire"] if sums["wire"] > 0 else 0.0,
    }
