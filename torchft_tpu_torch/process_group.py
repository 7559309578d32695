"""Reconfigurable process groups: the fault-tolerant communication backend.

Counterpart of ``torchft_tpu/process_group.py:125-300`` and its
``ProcessGroupHost`` (``:1262``): the ``ProcessGroup`` ABC with
value-returning collectives, a world-size-1 ``ProcessGroupDummy``, and
``ProcessGroupHost``, a TCP full mesh between replica groups that is torn
down and rebuilt per quorum through the rendezvous KV store.

Torch tensors (CUDA ones too) are staged to host numpy for the wire;
results come back as numpy and the caller lands them where it needs them.
Collectives run on one dispatch thread per generation (submission order is the
cross-replica contract) under an abort watchdog. Every collective uses the
one-round full-mesh exchange; the reference's bandwidth-optimal ring for
large payloads, its compressed self-healing ring and link-fault injection
are not ported yet.
"""

from __future__ import annotations

import enum
import logging
import pickle
import queue
import socket
import struct
import threading
from abc import ABC, abstractmethod
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchft_tpu_torch.coordination import KvClient
from torchft_tpu_torch.futures import context_timeout
from torchft_tpu_torch.work import DummyWork, Future, FutureWork, Work

logger = logging.getLogger(__name__)

__all__ = ["ReduceOp", "ProcessGroup", "ProcessGroupDummy", "ProcessGroupHost"]


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


def _accum(op: ReduceOp, dst: np.ndarray, src: np.ndarray) -> None:
    """In-place elementwise accumulate of one peer's contribution."""
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        dst += src
    elif op == ReduceOp.MAX:
        np.maximum(dst, src, out=dst)
    elif op == ReduceOp.MIN:
        np.minimum(dst, src, out=dst)
    elif op == ReduceOp.PRODUCT:
        dst *= src
    else:
        raise ValueError(f"unsupported reduce op: {op}")


def _reduce_np(op: ReduceOp, bufs: List[np.ndarray]) -> np.ndarray:
    out = bufs[0].copy()
    for b in bufs[1:]:
        _accum(op, out, b)
    if op == ReduceOp.AVG:
        out = out / len(bufs)
    return out


def _copy_payload(h: Any) -> Any:
    """Independent copy of a wire payload: ndarray, or a tuple holding
    ndarrays (the quantized ``(codes, scales, n)`` wire)."""
    if isinstance(h, np.ndarray):
        return h.copy()
    if isinstance(h, tuple):
        return tuple(x.copy() if isinstance(x, np.ndarray) else x for x in h)
    return h


def _to_host(x: Any) -> Any:
    """Stage a tensor (any device) to a host ndarray; tuples (the quantized
    wire) pass through."""
    if isinstance(x, (np.ndarray, tuple)):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ProcessGroup(ABC):
    """Abstract reconfigurable process group with value-returning
    collectives: each returns a Work whose future resolves to the result."""

    def __init__(self) -> None:
        self._timeout: float = 60.0

    @abstractmethod
    def configure(
        self,
        store_addr: str,
        replica_rank: int,
        replica_world_size: int,
        quorum_id: int = 0,
    ) -> None:
        """(Re)initialize the communicator for a new quorum. ``store_addr``
        is ``"host:port/prefix"`` into the rendezvous store."""

    @abstractmethod
    def abort(self) -> None:
        """Hard-kill in-flight collectives; errored until reconfigured."""

    @abstractmethod
    def shutdown(self) -> None:
        """Tear down (terminal)."""

    @abstractmethod
    def errored(self) -> Optional[Exception]:
        """Error state since the last configure, if any."""

    @abstractmethod
    def size(self) -> int: ...

    @abstractmethod
    def rank(self) -> int: ...

    def set_timeout(self, timeout: "float | timedelta") -> None:
        self._timeout = (
            timeout.total_seconds() if isinstance(timeout, timedelta) else timeout
        )

    @abstractmethod
    def allreduce(self, arrays: Sequence[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        """Future resolves to the reduced arrays (same structure as input)."""

    @abstractmethod
    def allgather(self, arrays: Sequence[Any]) -> Work:
        """Future resolves to a list (one per rank) of lists of arrays."""

    @abstractmethod
    def alltoall(self, input_chunks: Sequence[Any]) -> Work:
        """Future resolves to [chunk from rank 0, chunk from rank 1, ...]."""


class ProcessGroupDummy(ProcessGroup):
    """World-size-1 no-op PG: collectives return their inputs."""

    def __init__(self, rank: int = 0, world: int = 1) -> None:
        super().__init__()
        self._rank = rank
        self._world = world
        self.configure_count = 0

    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        self.configure_count += 1

    def abort(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def errored(self) -> Optional[Exception]:
        return None

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return DummyWork(list(arrays))

    def allgather(self, arrays):
        return DummyWork([list(arrays)])

    def alltoall(self, input_chunks):
        return DummyWork(list(input_chunks))


# ---------------------------------------------------------------------------
# Host TCP mesh
# ---------------------------------------------------------------------------
_HDR = struct.Struct("!Q")


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    mv = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(mv[got:], min(n - got, 1 << 20))
        if k == 0:
            raise ConnectionError("peer closed connection")
        got += k
    return buf


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)))
    sock.sendall(payload)


def _recv_msg(sock: socket.socket) -> bytearray:
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _recv_exact(sock, length)


class _Comm:
    """One generation of the TCP full mesh. Abort closes every socket so
    in-flight ops fail fast; the next configure builds a new generation."""

    def __init__(
        self, rank: int, world: int, store_addr: str, quorum_id: int, timeout: float
    ) -> None:
        self.rank = rank
        self.world = world
        self.aborted = False
        self._lock = threading.Lock()
        self.peers: Dict[int, socket.socket] = {}
        # writes ride one persistent worker so symmetric send/send between
        # two ranks cannot deadlock on full TCP buffers
        self._write_q: Optional["queue.Queue"] = None

        host_port, _, path = store_addr.partition("/")
        prefix = f"{path or 'pg'}/{quorum_id}"
        kv = KvClient(host_port, connect_timeout=timeout)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(world)
        self._listener = listener
        kv.set(
            f"{prefix}/addr_{rank}",
            f"{socket.gethostname()}:{listener.getsockname()[1]}",
            timeout=timeout,
        )
        # rank i dials every j < i and accepts from every j > i; a hello
        # frame carries the dialer's rank so accepts may arrive in any order
        for j in range(rank):
            addr = kv.get(f"{prefix}/addr_{j}", timeout=timeout).decode()
            host, _, p = addr.rpartition(":")
            s = socket.create_connection((host, int(p)), timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(s, pickle.dumps(("hello", rank)))
            self.peers[j] = s
        listener.settimeout(timeout)
        for _ in range(world - 1 - rank):
            s, _ = listener.accept()
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(timeout)
            tag, peer_rank = pickle.loads(_recv_msg(s))
            if tag != "hello":
                raise ConnectionError(f"bad handshake frame {tag!r}")
            self.peers[peer_rank] = s

    def send_to(self, peer: int, obj: Any) -> None:
        _send_msg(self.peers[peer], pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def recv_from(self, peer: int) -> Any:
        return pickle.loads(_recv_msg(self.peers[peer]))

    def _writer_loop(self, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            job, done, err = item
            try:
                job()
            except BaseException as e:  # noqa: BLE001 - handed to the waiter
                err.append(e)
            finally:
                done.set()

    def exchange(self, payloads: Dict[int, Any]) -> Dict[int, Any]:
        """Send ``payloads[r]`` to each rank r and receive one object from
        every peer: the writer worker streams the sends while this thread
        drains the receives."""
        done = threading.Event()
        err: List[BaseException] = []

        def _writes() -> None:
            for peer in sorted(payloads):
                if peer != self.rank:
                    self.send_to(peer, payloads[peer])

        with self._lock:
            if self.aborted:
                raise RuntimeError("communicator aborted")
            if self._write_q is None:
                self._write_q = queue.Queue()
                threading.Thread(
                    target=self._writer_loop, args=(self._write_q,), daemon=True,
                    name=f"pg_host_writer_r{self.rank}",
                ).start()
            self._write_q.put((_writes, done, err))
        out: Dict[int, Any] = {}
        if self.rank in payloads:
            out[self.rank] = payloads[self.rank]
        for peer in range(self.world):
            if peer != self.rank:
                out[peer] = self.recv_from(peer)
        done.wait()
        if err:
            raise err[0]
        return out

    def abort(self) -> None:
        with self._lock:
            self.aborted = True
            if self._write_q is not None:
                self._write_q.put(None)
            for s in list(self.peers.values()) + [self._listener]:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass


class ProcessGroupHost(ProcessGroup):
    """CPU collectives over a TCP full mesh between replica groups (the
    Gloo-equivalent plane). Ops run on one dispatch thread per generation,
    each under an abort watchdog of ``timeout`` seconds."""

    class _Generation:
        """One configure() generation: its mesh, dispatch queue and error.
        Ops are bound to the generation they were submitted under, so a late
        failure of a torn-down mesh never poisons the fresh one."""

        def __init__(self, comm: _Comm) -> None:
            self.comm = comm
            self.queue: "queue.Queue" = queue.Queue()
            self.error: Optional[Exception] = None

        def abort(self) -> None:
            if self.error is None:
                self.error = RuntimeError("process group aborted")
            self.comm.abort()

    def __init__(self, timeout: "float | timedelta" = 60.0) -> None:
        super().__init__()
        self.set_timeout(timeout)
        self._gen: Optional[ProcessGroupHost._Generation] = None
        self._rank = 0
        self._world = 1
        self._lock = threading.Lock()

    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        gen = ProcessGroupHost._Generation(
            _Comm(replica_rank, replica_world_size, store_addr, quorum_id, self._timeout)
        )
        with self._lock:
            old, self._gen = self._gen, gen
            self._rank = replica_rank
            self._world = replica_world_size
        if old is not None:
            old.abort()
            old.queue.put(None)
        threading.Thread(
            target=self._dispatch_loop, args=(gen,), daemon=True,
            name=f"pg_host_dispatch_r{replica_rank}",
        ).start()

    def abort(self) -> None:
        with self._lock:
            gen = self._gen
        if gen is not None:
            gen.abort()

    def shutdown(self) -> None:
        with self._lock:
            gen, self._gen = self._gen, None
        if gen is not None:
            gen.abort()
            gen.queue.put(None)

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._gen.error if self._gen is not None else None

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def _dispatch_loop(self, gen: "ProcessGroupHost._Generation") -> None:
        while True:
            item = gen.queue.get()
            if item is None:
                return
            fn, fut = item
            try:
                with context_timeout(gen.abort, self._timeout):
                    result = fn(gen.comm)
            except BaseException as e:  # noqa: BLE001 - resolves the op's future
                gen.error = e if isinstance(e, Exception) else RuntimeError(str(e))
                try:
                    fut.set_exception(e)
                except RuntimeError:
                    pass
            else:
                # outside the watchdog: chained callbacks must not be
                # charged against the collective's deadline
                try:
                    fut.set_result(result)
                except RuntimeError:
                    pass

    def _submit(self, fn: Callable[[_Comm], Any]) -> Work:
        with self._lock:
            gen = self._gen
            if gen is None:
                raise RuntimeError("process group is not configured")
            if gen.error is not None:
                raise gen.error
            fut: Future[Any] = Future()
            gen.queue.put((fn, fut))
            return FutureWork(fut)

    def allreduce(self, arrays, op=ReduceOp.SUM):
        host = [_to_host(a) for a in arrays]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [_copy_payload(h) for h in host]
            gathered = comm.exchange({r: host for r in range(comm.world)})
            return [
                _reduce_np(op, [gathered[r][i] for r in range(comm.world)])
                for i in range(len(host))
            ]

        return self._submit(_run)

    def allgather(self, arrays):
        host = [_to_host(a) for a in arrays]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [[_copy_payload(h) for h in host]]
            gathered = comm.exchange({r: host for r in range(comm.world)})
            return [gathered[r] for r in range(comm.world)]

        return self._submit(_run)

    def alltoall(self, input_chunks):
        host = [_to_host(a) for a in input_chunks]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [_copy_payload(h) for h in host]
            if len(host) != comm.world:
                raise ValueError(f"alltoall needs {comm.world} chunks, got {len(host)}")
            gathered = comm.exchange({r: host[r] for r in range(comm.world)})
            return [gathered[r] for r in range(comm.world)]

        return self._submit(_run)
