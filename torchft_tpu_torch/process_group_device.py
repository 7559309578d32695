"""The device plane: reconfigurable collectives whose payloads stay on the
device.

Counterpart of ``torchft_tpu/process_group_xla.py`` (``ProcessGroupXLA``,
``:419``). There is no XLA in it, so it does not carry the name. Every
collective of the host plane (``ProcessGroupHost``) stages its tensors to
the host and rides TCP; a ``ProcessGroupDevice`` hands CUDA tensors to
each other on the card, and says so with ``device_native = True``, which
tells the Manager to keep the payload there end to end.

Two modes, chosen at construction (``mode``; ``"auto"`` is local, as the
reference's ``:540-550``):

- **local**: one process owns every replica of the quorum, the replicas
  are threads (the reference's thread-per-replica harness and dryruns,
  and what runs on one card). Every replica's ``ProcessGroupDevice`` of
  one generation joins one process-global world, keyed by ``(store_addr,
  quorum_id, world_size)`` (superseded generations of the same store are
  pruned, ``:651-676``). An op rendezvouses by (kind, sequence number):
  each rank deposits its tensors, and the rank that arrives last runs the
  reduction with torch operations on the device and resolves every rank's
  future. A rank's lead device is the device of the tensors it deposits:
  on one card every replica's is ``cuda:0``. Where leads differ, the
  reduction runs on rank 0's device and the other contributions are copied
  there. (The reference gives each replica a device of its own and raises
  when the process holds fewer devices than the world, ``:188-200``.)

  Streams: a deposit records a CUDA event on the depositor's current
  stream; the reducing thread's stream waits on every deposit's event,
  then every depositor's stream waits on an event recorded after the
  reduction, so a rank reads its result on the stream it deposited from
  without a host synchronization. A tensor a rank receives from another
  rank is a copy (``allreduce``: a fresh tensor each), never storage
  another rank holds. As with NCCL, a deposited tensor must not be changed
  until the op's Work resolves.

- **distributed**: each rank is a process. One ``torch.distributed``
  group per quorum, built on a ``PrefixStore`` keyed by ``quorum_id``
  over a ``TCPStore`` that rank 0 serves, not on a global default group:
  NCCL for CUDA tensors (when the process has CUDA), gloo for CPU
  tensors. The prepare half (on the Manager's quorum thread) rendezvouses
  the ``TCPStore``'s address through the quorum-scoped KV store
  (``_stage_distributed``, ``:679``); the commit half builds the groups
  (``:695``). Ops run in issue order on one dispatch thread per process
  group, each bounded by the timeout with ``abort`` as its watchdog
  (``_distributed_work``, ``:468``); a collective itself fails after
  ``TORCHFT_XLA_HEARTBEAT_SEC`` (10 s), the seconds the mode takes to
  notice a dead peer (the reference's heartbeat, ``:85``). NCCL's
  watchdog would tear the process down on a timed-out collective;
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` is set to ``NCCL_ERROR_HANDLING``
  (2: abort the communicator and raise, keep the process) before an NCCL
  group is built, so the Manager sees a failed op and discards the step. gloo has no abort: ``abort()`` fails
  this rank's pending ops at once and drops the group on a thread, and a
  peer's op fails within the group's timeout. A torch communicator's
  rebuild leaves live tensors valid, so unlike the reference (``:100-121``)
  membership may change in place; ``device_world_epoch`` counts the
  rebuilds and nothing has to be re-landed.

``prepare_shrink`` (``:574``) fences a local-mode generation in place for
the intra-group degrade path. Timeout to abort, error swallowing and fault
injection come from the wrappers in ``process_group.py``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from datetime import timedelta
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import knobs
from torchft_tpu_torch.coordination import KvClient
from torchft_tpu_torch.futures import context_timeout
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.work import DummyWork, Future, FutureWork, Work

logger = logging.getLogger(__name__)

__all__ = ["ProcessGroupDevice"]

MODES = ("auto", "local", "distributed")

# TORCH_NCCL_ASYNC_ERROR_HANDLING for the device plane's NCCL groups: 2
# aborts the communicator and raises in the op, leaving the process alive
# (the default tears the process down)
NCCL_ERROR_HANDLING = "2"


def _avg(a: torch.Tensor) -> torch.Tensor:
    if a.dtype.is_floating_point:
        return a.mean(0)
    # an integer mean truncates back to the dtype, as the reference's
    # astype does
    return (a.sum(0, dtype=torch.float64) / a.shape[0]).to(a.dtype)


# each reduces a stack of the ranks' contributions over axis 0 (:74-80)
_REDUCERS: Dict[ReduceOp, Callable[[torch.Tensor], torch.Tensor]] = {
    ReduceOp.SUM: lambda a: a.sum(0, dtype=a.dtype),
    ReduceOp.AVG: _avg,
    ReduceOp.MAX: lambda a: a.amax(0),
    ReduceOp.MIN: lambda a: a.amin(0),
    ReduceOp.PRODUCT: lambda a: a.prod(0, dtype=a.dtype),
}


def _heartbeat_s() -> float:
    """Seconds the distributed mode takes to notice a dead peer: the
    timeout of its groups' collectives (gloo's and NCCL's)."""
    return knobs.env_float("TORCHFT_XLA_HEARTBEAT_SEC", 10.0)


def _my_host() -> str:
    return knobs.env_str("TORCHFT_HOST", "127.0.0.1")


def _as_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.as_tensor(np.asarray(a))


def _lead_of(tensors: Sequence[torch.Tensor]) -> torch.device:
    return tensors[0].device if tensors else torch.device("cpu")


class _Deposit(NamedTuple):
    """One rank's contribution: its tensors, its lead device, and (on
    CUDA) its current stream with an event recorded there at deposit."""

    payload: List[Any]
    lead: torch.device
    stream: Optional[Any]
    event: Optional[Any]


def _deposit(payload: List[Any], lead: torch.device) -> _Deposit:
    if lead.type != "cuda":
        return _Deposit(payload, lead, None, None)
    stream = torch.cuda.current_stream(lead)
    event = torch.cuda.Event()
    event.record(stream)
    return _Deposit(payload, lead, stream, event)


def _fresh(err: Exception) -> Exception:
    """A new exception like ``err``, for each future it fails and each
    raise: one object raised on many replicas' threads would keep every
    raising frame, and through them their callers (a crashed replica's
    Manager and model), in its traceback."""
    try:
        return type(err)(*err.args)
    except Exception:  # noqa: BLE001 - an exception type with other arguments
        return RuntimeError(str(err))


def _give(t: torch.Tensor, device: torch.device, own: bool) -> torch.Tensor:
    """``t`` for a rank on ``device``: its own tensor back as it is, any
    other rank's as a copy."""
    return t.to(device) if own else t.to(device, copy=True)


class _Mailbox:
    """Local-mode p2p handoff (one send/recv pairing, ``:203``)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._payload: Optional[_Deposit] = None
        self._set = False
        self._error: Optional[Exception] = None
        self._closed = False

    def put(self, payload: _Deposit) -> bool:
        """Deposit; False when the receiver already gave up (closed): the
        payload is dropped instead of pinned."""
        with self._cond:
            if self._closed:
                return False
            self._payload = payload
            self._set = True
            self._cond.notify_all()
        return True

    def close(self) -> None:
        """The receiver gave up (timeout or abort): a late put drops its
        payload."""
        with self._cond:
            self._closed = True
            self._payload = None
            self._cond.notify_all()

    def fail(self, err: Exception) -> None:
        """Wake a blocked get with ``err`` (abort)."""
        with self._cond:
            self._error = self._error or err
            self._cond.notify_all()

    def get(self, timeout: float) -> _Deposit:
        with self._cond:
            if not self._cond.wait_for(lambda: self._set or self._error is not None, timeout):
                raise TimeoutError("p2p recv timed out")
            if self._set:
                return self._payload  # type: ignore[return-value]
            raise _fresh(self._error)  # type: ignore[arg-type]


class _OpSlot:
    """Local-mode rendezvous of one collective across replica threads
    (``:251``)."""

    def __init__(self, world_size: int) -> None:
        self.world_size = world_size
        self.lock = threading.Lock()
        self.contributions: Dict[int, _Deposit] = {}
        self.futures: Dict[int, Future] = {}

    def deposit(self, rank: int, dep: _Deposit) -> Tuple[Future, bool]:
        """(this rank's future, whether it arrived last)."""
        with self.lock:
            self.contributions[rank] = dep
            fut = self.futures.setdefault(rank, Future())
            last = len(self.contributions) == self.world_size
        return fut, last

    def resolve(self, per_rank: Dict[int, Any]) -> None:
        with self.lock:
            futs = {r: self.futures.setdefault(r, Future()) for r in per_rank}
        for r, fut in futs.items():
            try:
                fut.set_result(per_rank[r])
            except RuntimeError:
                pass

    def fail(self, err: Exception) -> None:
        with self.lock:
            futs = [self.futures.setdefault(r, Future()) for r in range(self.world_size)]
        for fut in futs:
            try:
                fut.set_exception(_fresh(err))
            except RuntimeError:
                pass


class _DeviceWorld:
    """One configure generation (``_XlaWorld``, ``:290``). In local mode
    every replica's process group of the generation shares it and ops
    rendezvous by (kind, sequence number): aligned call order across
    replicas is the collective contract, as with NCCL. In distributed mode
    each process holds its own, with its torch.distributed groups."""

    def __init__(self, world_size: int, distributed: bool, quorum_id: int) -> None:
        self.world_size = world_size
        self.distributed = distributed
        self.quorum_id = quorum_id
        self.lock = threading.Lock()
        self.error: Optional[Exception] = None
        self.slots: Dict[Tuple[str, int], _OpSlot] = {}
        self.mailboxes: Dict[Tuple[str, int], _Mailbox] = {}
        # distributed mode: backend name -> c10d process group, and the
        # TCPStore they rendezvoused on (rank 0 serves it)
        self.groups: Dict[str, Any] = {}
        self.store: Optional[Any] = None

    def slot(self, kind: str, seq: int) -> _OpSlot:
        with self.lock:
            s = self.slots.get((kind, seq))
            if s is None:
                s = _OpSlot(self.world_size)
                self.slots[(kind, seq)] = s
        return s

    def gc_slot(self, kind: str, seq: int) -> None:
        with self.lock:
            self.slots.pop((kind, seq), None)

    def mailbox(self, kind: str, seq: int) -> _Mailbox:
        with self.lock:
            mb = self.mailboxes.get((kind, seq))
            if mb is None:
                mb = _Mailbox()
                self.mailboxes[(kind, seq)] = mb
        return mb

    def gc_mailbox(self, kind: str, seq: int) -> None:
        with self.lock:
            self.mailboxes.pop((kind, seq), None)

    def poison(self, err: Exception) -> None:
        """Fail every pending op of the generation with ``err``. The
        failures (and the callbacks they run: other replicas' Managers')
        run on a thread of their own, so no frame of the caller's, which
        may be a crashing replica's teardown, is kept by what they raise."""
        self.error = self.error or err

        def fail_all() -> None:
            with self.lock:
                slots = list(self.slots.values())
                mailboxes = list(self.mailboxes.values())
            for slot in slots:
                slot.fail(self.error)  # type: ignore[arg-type]
            for mb in mailboxes:
                mb.fail(self.error)  # type: ignore[arg-type]

        t = threading.Thread(target=fail_all, daemon=True, name="pgdevice_poison")
        t.start()
        t.join(5.0)


# the process-global local-mode registry (:413): every replica's process
# group of this process joins the same world per (store, quorum id, size)
_local_worlds: Dict[Tuple[str, int, int], _DeviceWorld] = {}
_local_worlds_lock = threading.Lock()


def _c10d_op(op: ReduceOp) -> Any:
    import torch.distributed as dist

    return {
        ReduceOp.SUM: dist.ReduceOp.SUM,
        ReduceOp.AVG: dist.ReduceOp.SUM,  # divided after the sum
        ReduceOp.MAX: dist.ReduceOp.MAX,
        ReduceOp.MIN: dist.ReduceOp.MIN,
        ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    }[op]


def _teardown_groups(world: _DeviceWorld, abort: bool) -> None:
    """Drop a distributed generation's groups on a thread, joined for at
    most 5 s: NCCL's aborted (or shut down, on a healthy retire), gloo's
    released (an op of it in flight runs to its timeout), the store last."""

    def teardown() -> None:
        nccl = world.groups.get("nccl")
        if nccl is not None:
            try:
                (nccl.shutdown if not abort and hasattr(nccl, "shutdown") else nccl.abort)()
            except Exception as e:  # noqa: BLE001 - teardown is best effort
                logger.warning("nccl group teardown failed: %s", e)
        world.groups.clear()
        world.store = None

    t = threading.Thread(target=teardown, daemon=True, name="pgdevice_teardown")
    t.start()
    t.join(5.0)


class ProcessGroupDevice(ProcessGroup):
    """Reconfigurable device-plane process group (module docstring).

    ``mode``: "auto" (local), "local" or "distributed". ``timeout``
    bounds each op of the distributed mode and a local ``recv``; local
    collectives are bounded by the Manager's deadline (it arms one at
    submission for a device-native group)."""

    device_native = True

    def __init__(self, timeout: "float | timedelta" = 60.0, mode: str = "auto") -> None:
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"ProcessGroupDevice mode must be one of {MODES}, got {mode!r}")
        self.set_timeout(timeout)
        self._mode = mode
        self._world: Optional[_DeviceWorld] = None
        self._rank = 0
        self._size = 1
        self._lock = threading.Lock()
        self._seq: Dict[str, int] = {}
        self._error: Optional[Exception] = None
        self._dispatch_q: Optional["queue.Queue"] = None
        # distributed ops submitted and not yet resolved: abort fails them
        self._pending: List[Future] = []
        self._device_world_epoch = 0
        # the last configure's arguments, for prepare_shrink
        self._last_configure: Optional[Tuple[str, int, int, int]] = None

    @property
    def mode(self) -> str:
        """The resolved mode: "local" or "distributed"."""
        return "local" if self._mode == "auto" else self._mode

    @property
    def requires_sync_quorum(self) -> bool:
        """False (``:445``): the control-plane part of a reconfigure runs in
        ``prepare_configure`` on the quorum thread, the group build is the
        commit the Manager runs on the main thread."""
        return False

    @property
    def device_world_epoch(self) -> int:
        """Bumped at every distributed group build (``:457``). The Manager
        records it at its sync points; a torch communicator's rebuild
        leaves live tensors valid, so nothing is re-landed."""
        with self._lock:
            return self._device_world_epoch

    # ------------------------------------------------------------ lifecycle
    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        commit = self.prepare_configure(store_addr, replica_rank, replica_world_size,
                                        quorum_id=quorum_id)
        if commit is not None:
            commit()

    def prepare_configure(
        self, store_addr, replica_rank, replica_world_size, quorum_id=0
    ) -> Optional[Callable[[], None]]:
        """Two-phase configure (``:528``). Local mode configures fully here
        and returns None. Distributed mode rendezvouses the TCPStore here
        and returns the group build as the commit."""
        with self._lock:
            self._last_configure = (store_addr, replica_rank, replica_world_size, quorum_id)
        if self.mode == "local":
            self._retire_current_world()
            world = self._configure_local(store_addr, replica_world_size, quorum_id)
            self._install_world(world, replica_rank, replica_world_size)
            return None

        store = self._stage_distributed(store_addr, replica_rank, replica_world_size, quorum_id)

        def commit() -> None:
            self._retire_current_world()
            world = self._configure_distributed(store, replica_rank, replica_world_size,
                                                quorum_id)
            self._install_world(world, replica_rank, replica_world_size)

        return commit

    def prepare_shrink(self, dead_group_rank: int) -> Optional[Callable[[], None]]:
        """The intra-group degrade path (``:574``): a member of this
        replica's group died and the group shrinks in place. Local mode
        returns a commit that poisons the current generation (failing ops
        entangled with the dead member) and re-lands the same coordinates
        on a fresh one. Distributed mode raises: its groups change only
        through a new quorum's rendezvous, so the Manager takes the
        leave-heal-rejoin path."""
        with self._lock:
            world = self._world
            args = self._last_configure
        if world is None or args is None:
            return None
        if world.distributed:
            raise RuntimeError(
                "distributed-mode ProcessGroupDevice cannot shrink intra-group membership in "
                f"place (member {dead_group_rank} lost): its groups are rebuilt only through a "
                "new quorum's rendezvous, so the group takes the leave-heal-rejoin path")
        store_addr, replica_rank, replica_world_size, quorum_id = args

        def commit() -> None:
            self._retire_current_world()
            w = self._configure_local(store_addr, replica_world_size, quorum_id)
            self._install_world(w, replica_rank, replica_world_size)

        return commit

    def _retire_current_world(self) -> None:
        with self._lock:
            old, self._world = self._world, None
            self._seq = {}  # fresh op ordering per generation
        if old is None:
            return
        if old.distributed:
            _teardown_groups(old, abort=False)
        else:
            # ops pending in the abandoned generation can never complete:
            # fail them now rather than at co-resident replicas' timeouts
            old.poison(RuntimeError("process group torn down for reconfiguration"))

    def _install_world(self, world: _DeviceWorld, replica_rank: int, replica_world_size: int) -> None:
        with self._lock:
            self._world = world
            self._rank = replica_rank
            self._size = replica_world_size
            self._error = None  # the errored state clears on reconfigure

    def _configure_local(self, store_addr: str, world_size: int, quorum_id: int) -> _DeviceWorld:
        base = store_addr.split("/", 1)[0]  # the store's host:port
        key = (store_addr, quorum_id, world_size)
        with _local_worlds_lock:
            world = _local_worlds.get(key)
            if world is not None and world.error is not None:
                # a poisoned generation is never handed back: build afresh
                world = None
            if world is None:
                world = _DeviceWorld(world_size, distributed=False, quorum_id=quorum_id)
                # prune superseded generations of the same store (host:port
                # matched exactly: :5000 must not reap :50001)
                for k in [k for k in _local_worlds
                          if k[0].split("/", 1)[0] == base and k[1] < quorum_id]:
                    del _local_worlds[k]
                _local_worlds[key] = world
        return world

    def _stage_distributed(self, store_addr: str, rank: int, world_size: int,
                           quorum_id: int) -> Any:
        """The control-plane half of a distributed reconfigure, safe on the
        quorum thread: rank 0 serves a TCPStore and publishes its address
        under the quorum-scoped KV prefix, every other rank reads it and
        connects."""
        from torch.distributed import TCPStore

        host_port, _, path = store_addr.partition("/")
        prefix = f"{path or 'pgdevice'}/{quorum_id}"
        kv = KvClient(host_port, connect_timeout=self._timeout)
        timeout = timedelta(seconds=self._timeout)
        if rank == 0:
            host = _my_host()
            store = TCPStore(host, 0, world_size, is_master=True, timeout=timeout,
                             wait_for_workers=False)
            kv.set(f"{prefix}/device_store", f"{host}:{store.port}", timeout=self._timeout)
            return store
        addr = kv.get(f"{prefix}/device_store", timeout=self._timeout).decode()
        host, port = addr.rsplit(":", 1)
        return TCPStore(host, int(port), world_size, is_master=False, timeout=timeout)

    def _configure_distributed(self, store: Any, rank: int, world_size: int,
                               quorum_id: int) -> _DeviceWorld:
        """The commit half (``:695``): this quorum's groups on a PrefixStore
        keyed by ``quorum_id``. gloo always; NCCL when the process has
        CUDA, its communicator made at its first op."""
        import torch.distributed as dist

        timeout = timedelta(seconds=_heartbeat_s())
        prefixed = dist.PrefixStore(f"device/{quorum_id}", store)
        world = _DeviceWorld(world_size, distributed=True, quorum_id=quorum_id)
        world.store = store
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        opts._devices = [dist.ProcessGroupGloo.create_device(hostname=_my_host())]
        world.groups["gloo"] = dist.ProcessGroupGloo(
            dist.PrefixStore("gloo", prefixed), rank, world_size, opts)
        if torch.cuda.is_available():
            # imported here: a CPU-only torch has no ProcessGroupNCCL
            from torch.distributed import ProcessGroupNCCL

            os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = NCCL_ERROR_HANDLING
            nccl_opts = ProcessGroupNCCL.Options()
            nccl_opts._timeout = timeout
            world.groups["nccl"] = ProcessGroupNCCL(
                dist.PrefixStore("nccl", prefixed), rank, world_size, nccl_opts)
        with self._lock:
            self._device_world_epoch += 1
        return world

    def abort(self) -> None:
        err = RuntimeError("process group aborted")
        with self._lock:
            world, self._world = self._world, None
            self._error = self._error or err
            q, self._dispatch_q = self._dispatch_q, None
            pending, self._pending = self._pending, []
        if q is not None:
            q.put(None)  # the pump stops after the op in hand
        for fut in pending:
            try:
                fut.set_exception(_fresh(err))
            except RuntimeError:
                pass
        if world is None:
            return
        world.poison(err)
        if world.distributed:
            _teardown_groups(world, abort=True)

    def shutdown(self) -> None:
        self.abort()

    def errored(self) -> Optional[Exception]:
        """This group's error since its last configure: its own abort, or
        an op of its own that failed. A replica that leaves the generation
        fails the ops it leaves pending and every later one, but marks no
        group whose ops all completed: that replica's step commits (the
        reference's reads the shared generation's error, ``:841``)."""
        with self._lock:
            return self._error

    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    # ------------------------------------------------------------ internals
    def _require_world(self) -> _DeviceWorld:
        with self._lock:
            world = self._world
        if world is None:
            raise RuntimeError("process group is not configured")
        if world.error is not None:
            raise _fresh(world.error)
        return world

    def _bump_seq(self, kind: str) -> int:
        with self._lock:
            n = self._seq.get(kind, 0)
            self._seq[kind] = n + 1
        return n

    def _local_op(self, world: _DeviceWorld, kind: str, payload: List[Any], lead: torch.device,
                  compute: Callable[[Dict[int, _Deposit]], Dict[int, Any]]) -> Work:
        """Deposit this rank's payload for the next op of ``kind``; the rank
        arriving last runs ``compute`` over every deposit and resolves every
        rank's future."""
        seq = self._bump_seq(kind)
        slot = world.slot(kind, seq)
        fut, last = slot.deposit(self._rank, _deposit(payload, lead))
        work = self._watched(world, fut)
        # abort fails the slots it can see under world.lock after setting
        # world.error: a slot it missed sees the error here
        if world.error is not None:
            slot.fail(world.error)
            world.gc_slot(kind, seq)
            return work
        if last:
            try:
                slot.resolve(_run_synced(slot.contributions, compute))
            except Exception as e:  # noqa: BLE001 - fails every rank's op
                world.error = world.error or e
                slot.fail(e)
            finally:
                world.gc_slot(kind, seq)
        return work

    def _watched(self, world: _DeviceWorld, fut: Future) -> Work:
        """This rank's Work on ``fut``: a failure marks this group errored
        (until its next configure) before the Work resolves."""
        out: Future = Future()

        def forward(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                out.set_result(f.value())
                return
            with self._lock:
                if self._world is world and self._error is None:
                    self._error = _fresh(exc)  # type: ignore[arg-type]
            out.set_exception(exc)

        fut.add_done_callback(forward)
        return FutureWork(out)

    def _distributed_work(self, world: _DeviceWorld, fn: Callable[[], Any],
                          inputs: Sequence[torch.Tensor]) -> Work:
        """A distributed-mode op on the group's dispatch thread, in issue
        order, bounded by the timeout with ``abort`` as the watchdog
        (``:468``). Its CUDA inputs are waited for on the dispatch thread's
        stream, and its CUDA outputs are complete when the future
        resolves."""
        fut: Future = Future()
        timeout = self._timeout
        ready = _deposit([], _lead_of(inputs))

        def run() -> None:
            try:
                with context_timeout(self.abort, timeout):
                    if ready.event is not None:
                        torch.cuda.current_stream(ready.lead).wait_event(ready.event)
                    out = fn()
                    if ready.lead.type == "cuda":
                        torch.cuda.current_stream(ready.lead).synchronize()
                fut.set_result(out)
            except Exception as e:  # noqa: BLE001 - resolves the op
                try:
                    fut.set_exception(e)
                except RuntimeError:
                    pass
            finally:
                with self._lock:
                    if fut in self._pending:
                        self._pending.remove(fut)

        # enqueued under the lock: abort swaps the queue and posts the
        # sentinel under it, so no op lands behind the sentinel
        with self._lock:
            if self._error is not None:
                raise _fresh(self._error)
            if self._dispatch_q is None:
                q: "queue.Queue" = queue.Queue()
                self._dispatch_q = q

                def pump() -> None:
                    while True:
                        item = q.get()
                        if item is None:
                            return
                        item()

                threading.Thread(target=pump, daemon=True, name="pgdevice_dispatch").start()
            self._pending.append(fut)
            self._dispatch_q.put(run)
        return self._watched(world, fut)

    # ----------------------------------------------------------- collectives
    def allreduce(self, arrays: Sequence[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        """Resolves to the reduced tensors, on this rank's device."""
        world = self._require_world()
        leaves = [_as_tensor(a) for a in arrays]
        lead = _lead_of(leaves)
        leaves = [t.to(lead) for t in leaves]
        if world.distributed:
            # the group reduces in place: a copy, taken in the caller's order
            bufs = [t.clone() for t in leaves]
            return self._distributed_work(
                world, lambda: _dist_allreduce(world, bufs, op), bufs)

        def compute(contribs: Dict[int, _Deposit]) -> Dict[int, Any]:
            reduce_dev = contribs[0].lead
            outs = []
            for i in range(len(leaves)):
                stacked = torch.stack([contribs[r].payload[i].to(reduce_dev)
                                       for r in range(world.world_size)])
                outs.append(_REDUCERS[op](stacked))
                del stacked
            # rank 0 keeps the reduced tensors, every other rank a copy
            return {r: [_give(o, d.lead, own=r == 0) for o in outs]
                    for r, d in contribs.items()}

        return self._local_op(world, "allreduce", leaves, lead, compute)

    def allgather(self, arrays: Sequence[Any]) -> Work:
        """Resolves to ``[rank 0's tensors, rank 1's tensors, ...]``."""
        world = self._require_world()
        leaves = [_as_tensor(a) for a in arrays]
        lead = _lead_of(leaves)
        leaves = [t.to(lead) for t in leaves]
        if world.distributed:
            return self._distributed_work(world, lambda: _dist_allgather(world, leaves), leaves)

        def compute(contribs: Dict[int, _Deposit]) -> Dict[int, Any]:
            return {r: [[_give(t, d.lead, own=src == r) for t in contribs[src].payload]
                        for src in range(world.world_size)]
                    for r, d in contribs.items()}

        return self._local_op(world, "allgather", leaves, lead, compute)

    def broadcast(self, arrays: Sequence[Any], root: int = 0) -> Work:
        """Root's tensors land on every rank (each rank passes tensors of
        the same shapes; a non-root rank's values are not read)."""
        world = self._require_world()
        leaves = [_as_tensor(a) for a in arrays]
        lead = _lead_of(leaves)
        leaves = [t.to(lead) for t in leaves]
        if world.distributed:
            bufs = [t.clone() for t in leaves]
            return self._distributed_work(world, lambda: _dist_broadcast(world, bufs, root), bufs)

        def compute(contribs: Dict[int, _Deposit]) -> Dict[int, Any]:
            src = contribs[root].payload
            return {r: [_give(t, d.lead, own=r == root) for t in src]
                    for r, d in contribs.items()}

        payload = leaves if self._rank == root else []
        return self._local_op(world, "broadcast", payload, lead, compute)

    def reduce_scatter(self, input_chunks: Sequence[Sequence[Any]],
                       op: ReduceOp = ReduceOp.SUM) -> Work:
        """``input_chunks[r]``: this rank's contribution destined for rank
        r; resolves to the reduced chunk this rank owns."""
        world = self._require_world()
        n_per_dest = len(input_chunks[0]) if input_chunks else 0
        leaves = [_as_tensor(a) for chunk in input_chunks for a in chunk]
        lead = _lead_of(leaves)
        leaves = [t.to(lead) for t in leaves]
        rank = self._rank
        if world.distributed:
            bufs = [t.clone() for t in leaves]

            def run() -> List[torch.Tensor]:
                # every chunk reduced, this rank's kept (the reference's :1063)
                return _dist_allreduce(world, bufs, op)[rank * n_per_dest:(rank + 1) * n_per_dest]

            return self._distributed_work(world, run, bufs)

        def compute(contribs: Dict[int, _Deposit]) -> Dict[int, Any]:
            reduce_dev = contribs[0].lead
            out: Dict[int, Any] = {}
            for r, d in contribs.items():
                mine = []
                for i in range(r * n_per_dest, (r + 1) * n_per_dest):
                    stacked = torch.stack([contribs[s].payload[i].to(reduce_dev)
                                           for s in range(world.world_size)])
                    # each reduced chunk goes to its one owner
                    mine.append(_REDUCERS[op](stacked).to(d.lead))
                    del stacked
                out[r] = mine
            return out

        return self._local_op(world, "reduce_scatter", leaves, lead, compute)

    def alltoall(self, input_chunks: Sequence[Any]) -> Work:
        """``input_chunks[r]``: the chunk destined for rank r; resolves to
        ``[chunk from rank 0, chunk from rank 1, ...]``."""
        world = self._require_world()
        rank = self._rank
        leaves = [_as_tensor(a) for a in input_chunks]
        lead = _lead_of(leaves)
        leaves = [t.to(lead) for t in leaves]
        if world.distributed:
            # the reference's: an allgather, each rank keeping its column
            return self._distributed_work(
                world, lambda: [row[rank] for row in _dist_allgather(world, leaves)], leaves)

        def compute(contribs: Dict[int, _Deposit]) -> Dict[int, Any]:
            return {r: [_give(contribs[src].payload[r], d.lead, own=src == r)
                        for src in range(world.world_size)]
                    for r, d in contribs.items()}

        return self._local_op(world, "alltoall", leaves, lead, compute)

    # ------------------------------------------------------------------ p2p
    def send(self, arrays: Sequence[Any], dst: int, tag: int = 0) -> Work:
        world = self._require_world()
        if world.distributed:
            raise RuntimeError(
                "ProcessGroupDevice p2p send/recv is local-mode only; pairwise transfers "
                "between processes belong to the checkpoint transports or the host plane")
        kind = f"p2p_{self._rank}_{dst}_{tag}"
        seq = self._bump_seq(kind)
        leaves = [_as_tensor(a) for a in arrays]
        if not world.mailbox(kind, seq).put(_deposit(leaves, _lead_of(leaves))):
            # the receiver already gave this pairing up
            world.gc_mailbox(kind, seq)
        return DummyWork(None)

    def recv(self, src: int, tag: int = 0) -> Work:
        """Resolves to copies of the sent tensors, on the sender's device,
        complete on the device."""
        world = self._require_world()
        if world.distributed:
            raise RuntimeError(
                "ProcessGroupDevice p2p send/recv is local-mode only; pairwise transfers "
                "between processes belong to the checkpoint transports or the host plane")
        kind = f"p2p_{src}_{self._rank}_{tag}"
        seq = self._bump_seq(kind)
        mb = world.mailbox(kind, seq)
        fut: Future = Future()
        timeout = self._timeout

        def do_recv() -> None:
            try:
                dep = mb.get(timeout)
                out = _run_synced({0: dep}, lambda c: {0: [t.clone() for t in c[0].payload]})[0]
                if dep.lead.type == "cuda":
                    torch.cuda.current_stream(dep.lead).synchronize()
                fut.set_result(out)
                # consumed once: drop the mailbox and its tensors
                world.gc_mailbox(kind, seq)
            except Exception as e:  # noqa: BLE001 - resolves the op
                try:
                    fut.set_exception(e)
                except RuntimeError:
                    pass
                # closed but kept: a late sender finds it and drops its payload
                mb.close()

        threading.Thread(target=do_recv, daemon=True, name="pgdevice_recv").start()
        return FutureWork(fut)


def _run_synced(contribs: Dict[int, _Deposit],
                compute: Callable[[Dict[int, _Deposit]], Dict[int, Any]]) -> Dict[int, Any]:
    """Run ``compute`` on this thread's streams after every deposit's
    event, then make every depositor's stream wait for what it launched."""
    cuda_devs = {d.lead for d in contribs.values() if d.lead.type == "cuda"}
    for d in contribs.values():
        if d.event is not None:
            torch.cuda.current_stream(d.lead).wait_event(d.event)
    out = compute(contribs)
    done = {}
    for dev in cuda_devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        done[dev] = ev
    for d in contribs.values():
        if d.stream is not None:
            d.stream.wait_event(done[d.lead])
    return out


def _group(world: _DeviceWorld, tensors: Sequence[torch.Tensor]) -> Any:
    backend = "nccl" if tensors and tensors[0].is_cuda else "gloo"
    group = world.groups.get(backend)
    if group is None:
        raise RuntimeError(f"no {backend} group in this process for {tensors[0].device} tensors")
    return group


def _dist_allreduce(world: _DeviceWorld, bufs: List[torch.Tensor], op: ReduceOp) -> List[torch.Tensor]:
    import torch.distributed as dist

    if not bufs:
        return []
    group = _group(world, bufs)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _c10d_op(op)
    for t in bufs:
        group.allreduce([t], opts).wait()
    if op == ReduceOp.AVG:
        bufs = [_avg_of_sum(t, world.world_size) for t in bufs]
    return bufs


def _avg_of_sum(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.dtype.is_floating_point:
        return t.div_(n)
    return (t.to(torch.float64) / n).to(t.dtype)


def _dist_allgather(world: _DeviceWorld, leaves: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    if not leaves:
        return [[] for _ in range(world.world_size)]
    group = _group(world, leaves)
    per_leaf = []
    for t in leaves:
        outs = [torch.empty_like(t) for _ in range(world.world_size)]
        group.allgather([outs], [t.contiguous()]).wait()
        per_leaf.append(outs)
    return [[outs[src] for outs in per_leaf] for src in range(world.world_size)]


def _dist_broadcast(world: _DeviceWorld, bufs: List[torch.Tensor], root: int) -> List[torch.Tensor]:
    import torch.distributed as dist

    if not bufs:
        return []
    group = _group(world, bufs)
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    opts.rootTensor = 0
    for t in bufs:
        group.broadcast([t], opts).wait()
    return bufs
