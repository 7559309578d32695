"""Reconfigurable process groups: the fault-tolerant communication backend.

Counterpart of ``torchft_tpu/process_group.py:125-300`` and its
``ProcessGroupHost`` (``:1262``): the ``ProcessGroup`` ABC with
value-returning collectives and point-to-point ``send`` / ``recv`` /
``recv_into``, a world-size-1 ``ProcessGroupDummy``, and
``ProcessGroupHost``, a TCP full mesh between replica groups that is torn
down and rebuilt per quorum through the rendezvous KV store.

Torch tensors (CUDA ones too) are staged to the host for the wire: as
numpy, or, for bf16 (which numpy lacks), as CPU torch tensors, whose sums
torch rounds to bf16 at each add as ml_dtypes does for the reference; a
bf16 segment rides the socket as its raw 16-bit patterns. Results come
back on the host and the caller lands them where it needs them.
Collectives run on one dispatch thread per generation (submission order is
the cross-replica contract) under an abort watchdog. ``allreduce`` routes
as the reference's (``:1485-1530``):

- one ``CompressedWire`` (a streamed bucket's codes): the compressed
  self-healing ring (``:716-1260``), which dequantizes, sums in f32 and
  requantizes at each hop, and re-routes around a dead link mid-collective
  (``inject_link_fault`` arms one). A wire coded on the card keeps its
  hops' arithmetic there (``ops.quantization``'s kernels); only codes and
  scales cross the host;
- buffers of ``_RING_MIN_BYTES`` or more: the bandwidth-optimal ring
  (``:631-714``), raw frames straight from the working buffer;
- anything else: the one-round full-mesh exchange of pickled payloads.

Point-to-point sends ride a writer thread per peer (``:565``, ``:1601``):
``_RING_MIN_BYTES`` or more of host buffers go as a pickled header of
dtypes and shapes and then raw frames, anything else pickled. CUDA tensors
are staged through page-locked host memory, and ``recv_into`` a CUDA
tensor lands the frame in that tensor's storage. One generation carries
either p2p or collective traffic, never both (frame order on a shared
socket): a checkpoint transport gets a process group of its own.

Configure has the reference's two phases (``prepare_configure``,
``:151``): the Manager runs ``prepare_configure`` on its quorum thread and
applies the commit it returns, if any, from the main thread at the next
safe point. Every process group here configures fully in the prepare and
returns None.

``ProcessGroupBaby`` / ``ProcessGroupBabyHost`` (``:1693-2102``) run a
``ProcessGroupHost`` in a child process (the ``spawn`` context, or a
thread under ``multiprocessing_dummy_context.DummyContext``), anew at each
configure, so a wedged communicator is killed without the trainer; host
arrays cross its pipes, their bytes out of band.

Wrappers: ``ErrorSwallowingProcessGroupWrapper`` (``:2104-2268``) turns a
failed op into its input and keeps the error until the next configure;
``ManagedProcessGroup`` (``:2461``) routes ``allreduce`` through a
Manager; ``FakeProcessGroupWrapper`` (``:2269``) fails the futures of
chosen ops, or the next ``configure``, for tests.
"""

from __future__ import annotations

import enum
import itertools
import logging
import pickle
import queue
import socket
import struct
import threading
import time
from abc import ABC, abstractmethod
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import torchft_tpu_torch.flight_recorder as _fr
from torchft_tpu_torch.coordination import KvClient
from torchft_tpu_torch.futures import context_timeout
from torchft_tpu_torch.observability import log_error_event
from torchft_tpu_torch.ops.quantization import (
    CompressedWire,
    codec,
    decode_fp8_on_card,
    dtype_name,
    encode_fp8_on_card,
    host_empty,
    is_compressed_wire,
    on_card,
)
from torchft_tpu_torch.retry import RetryPolicy, retry_call
from torchft_tpu_torch.utils import true_divide
from torchft_tpu_torch.work import DummyWork, Future, FutureWork, Work

logger = logging.getLogger(__name__)

__all__ = [
    "ReduceOp", "ProcessGroup", "ProcessGroupDummy", "ProcessGroupHost",
    "ProcessGroupBaby", "ProcessGroupBabyHost", "ErrorSwallowingProcessGroupWrapper", "FakeProcessGroupWrapper", "ManagedProcessGroup",
]


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


# a host buffer: an ndarray, or a CPU tensor of a dtype numpy lacks (bf16)
_BUFFERS = (np.ndarray, torch.Tensor)


def _accum(op: ReduceOp, dst: Any, src: Any) -> None:
    """In-place elementwise accumulate of one peer's contribution, shared
    by the full-mesh exchange (_reduce_np) and the ring (_ring_allreduce)."""
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        dst += src
    elif op == ReduceOp.PRODUCT:
        dst *= src
    elif op in (ReduceOp.MAX, ReduceOp.MIN):
        if isinstance(dst, torch.Tensor):
            fn = torch.maximum if op == ReduceOp.MAX else torch.minimum
            fn(dst, src, out=dst)
        else:
            fn = np.maximum if op == ReduceOp.MAX else np.minimum
            fn(dst, src, out=dst)
    else:
        raise ValueError(f"unsupported reduce op: {op}")


def _reduce_np(op: ReduceOp, bufs: List[Any]) -> Any:
    out = _copy_payload(bufs[0])
    for b in bufs[1:]:
        _accum(op, out, b)
    if op == ReduceOp.AVG:
        out = out / len(bufs)
    return out


def _copy_payload(h: Any) -> Any:
    """Independent copy of a wire payload: a host buffer, or a tuple
    holding ndarrays (the quantized ``(codes, scales, n)`` wire)."""
    if isinstance(h, np.ndarray):
        return h.copy()
    if isinstance(h, torch.Tensor):
        return h.clone()
    if isinstance(h, tuple):
        return tuple(x.copy() if isinstance(x, np.ndarray) else x for x in h)
    return h


def _to_host(x: Any) -> Any:
    """Stage a tensor (any device) to the host: an ndarray, or a CPU tensor
    for bf16. Ndarrays and tuples (the quantized wires) pass through."""
    if isinstance(x, (np.ndarray, tuple)):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def _byte_view(buf: Any) -> np.ndarray:
    """The bytes of a contiguous host buffer as a flat uint8 ndarray that
    shares its memory (bf16 tensors included, whose dtype memoryview
    cannot export)."""
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8).numpy()
    return np.asarray(buf).reshape(-1).view(np.uint8)  # reshape first: 0-d safe


def _nbytes(buf: Any) -> int:
    if isinstance(buf, torch.Tensor):
        return buf.numel() * buf.element_size()
    return buf.nbytes


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

    def prepare_configure(
        self,
        store_addr: str,
        replica_rank: int,
        replica_world_size: int,
        quorum_id: int = 0,
    ) -> Optional[Callable[[], None]]:
        """Two-phase configure: do now what is safe off the main thread and
        return the main-thread commit, or None when nothing is left.

        The default is all prepare: it runs ``self.configure`` (the
        attribute, so a configure shadowed on the instance still sees every
        reconfigure) and returns None."""
        self.configure(store_addr, replica_rank, replica_world_size, quorum_id=quorum_id)
        return None

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
    def broadcast(self, arrays: Sequence[Any], root: int = 0) -> Work:
        """Future resolves to root's arrays on every rank."""

    @abstractmethod
    def alltoall(self, input_chunks: Sequence[Any]) -> Work:
        """Future resolves to [chunk from rank 0, chunk from rank 1, ...]."""

    @abstractmethod
    def send(self, arrays: Sequence[Any], dst: int, tag: int = 0) -> Work:
        """Future resolves to None once the arrays are written to ``dst``."""

    @abstractmethod
    def recv(self, src: int, tag: int = 0) -> Work:
        """Future resolves to the received arrays (host buffers)."""

    # whether send/recv_into move raw frames straight between buffers (the
    # ranged checkpoint wire needs them)
    streams_raw_frames = False

    def recv_into(self, buffers: Sequence[Any], src: int, tag: int = 0) -> Work:
        """``recv`` that may land the arrays in ``buffers``: entry i of the
        result IS ``buffers[i]`` when it absorbed the frame, else a fresh
        array the caller copies from. This default absorbs nothing."""
        return self.recv(src, tag)


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

    def broadcast(self, arrays, root=0):
        return DummyWork(list(arrays))

    def alltoall(self, input_chunks):
        return DummyWork(list(input_chunks))

    def send(self, arrays, dst, tag=0):
        return DummyWork(None)

    def recv(self, src, tag=0):
        return DummyWork(None)


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
        # frames from the dispatch thread, the collective writer and the
        # p2p writers must never interleave on one socket
        self._send_locks: Dict[int, threading.Lock] = {}
        # one p2p writer per peer (strict FIFO), started at its first send
        self._p2p_queues: Dict[int, "queue.Queue"] = {}
        # writes ride one persistent worker so symmetric send/send between
        # two ranks cannot deadlock on full TCP buffers
        self._coll_q: Optional["queue.Queue"] = None
        # traffic: frame bytes each way, and the seconds spent inside
        # sendall pushing frames (receive waits are not counted: a recv
        # blocked on a peer still computing is not wire time)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.wire_busy_s = 0.0
        # injected link faults {frozenset({a, b}): first hop}, shared with
        # the owning ProcessGroupHost; read by the compressed ring only
        self.link_faults: Dict[frozenset, int] = {}
        # compressed-collective sequence number (ops dispatch in one order
        # on every rank): hop frames carry (seq, attempt) so a re-routed
        # ring tells a stale frame from a live one
        self.cring_seq = 0
        # links seen dead: later collectives of this generation avoid them
        self.cring_dead: set = set()

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
        for j in self.peers:
            self._send_locks[j] = threading.Lock()

    def send_to(self, peer: int, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        with self._send_locks[peer]:
            t0 = time.perf_counter()
            _send_msg(self.peers[peer], payload)
            self.wire_busy_s += time.perf_counter() - t0
            self.bytes_sent += len(payload) + _HDR.size

    def recv_from(self, peer: int) -> Any:
        payload = _recv_msg(self.peers[peer])
        self.bytes_recv += len(payload) + _HDR.size
        return pickle.loads(payload)

    def send_raw(self, peer: int, buf: Any) -> None:
        """One frame of a contiguous host buffer's bytes, unpickled: the
        length header, then the bytes straight from the buffer."""
        mv = memoryview(_byte_view(buf))
        sock = self.peers[peer]
        with self._send_locks[peer]:
            t0 = time.perf_counter()
            sock.sendall(_HDR.pack(len(mv)))
            sock.sendall(mv)
            self.wire_busy_s += time.perf_counter() - t0
            self.bytes_sent += len(mv) + _HDR.size

    def send_hop(self, peer: int, hdr: tuple, q: Any, s: Any) -> None:
        """A compressed-ring hop: the pickled header, then the codes and
        the scales as raw frames, all under one hold of the peer's send
        lock. Sent as three separately locked frames (as the reference
        does), a re-route signal from the dispatch thread could land
        between the header and its bodies and desync the receiver."""
        payload = pickle.dumps(hdr, protocol=pickle.HIGHEST_PROTOCOL)
        bodies = [memoryview(_byte_view(q)), memoryview(_byte_view(s))]
        sock = self.peers[peer]
        with self._send_locks[peer]:
            t0 = time.perf_counter()
            _send_msg(sock, payload)
            for mv in bodies:
                sock.sendall(_HDR.pack(len(mv)))
                sock.sendall(mv)
            self.wire_busy_s += time.perf_counter() - t0
            self.bytes_sent += len(payload) + sum(len(mv) for mv in bodies) + 3 * _HDR.size

    def recv_raw_into(self, peer: int, out: Any) -> None:
        """Receive one raw frame straight into a contiguous host buffer of
        the frame's size."""
        sock = self.peers[peer]
        (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
        mv = memoryview(_byte_view(out))
        if length != len(mv):
            raise ValueError(f"frame size {length} != buffer size {len(mv)}")
        got = 0
        while got < length:
            k = sock.recv_into(mv[got:], min(length - got, 1 << 20))
            if k == 0:
                raise ConnectionError("peer closed connection")
            got += k
        self.bytes_recv += length + _HDR.size

    def recv_raw_discard(self, peer: int) -> int:
        """Read one raw frame and drop its bytes (a re-routed compressed
        ring drains an aborted attempt's segments with it). Returns the
        byte count."""
        sock = self.peers[peer]
        (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
        scratch = memoryview(bytearray(min(length, 1 << 20) or 1))
        got = 0
        while got < length:
            k = sock.recv_into(scratch, min(length - got, len(scratch)))
            if k == 0:
                raise ConnectionError("peer closed connection")
            got += k
        self.bytes_recv += length + _HDR.size
        return length

    def check_link_fault(self, a: int, b: int, hop: int) -> None:
        """Raise ConnectionError if an injected fault covers link (a, b) at
        this hop. A fired fault stays armed: a dead link stays dead for the
        generation, which forces the ring to re-form around it."""
        at_hop = self.link_faults.get(frozenset((a, b)))
        if at_hop is not None and hop >= at_hop:
            raise ConnectionError(f"injected link failure {a}<->{b} at hop {hop}")

    def _coll_writer_loop(self, q: "queue.Queue") -> None:
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

    def submit_write(self, job: Callable[[], None]) -> Tuple[threading.Event, List[BaseException]]:
        """Run ``job`` on the persistent collective-writer thread; returns
        ``(done_event, errors)``. The aborted check and the enqueue share
        ``_lock`` with abort's shutdown sentinel, so a job never lands
        behind it."""
        done = threading.Event()
        err: List[BaseException] = []
        with self._lock:
            if self.aborted:
                raise RuntimeError("communicator aborted")
            if self._coll_q is None:
                self._coll_q = queue.Queue()
                threading.Thread(
                    target=self._coll_writer_loop, args=(self._coll_q,), daemon=True,
                    name=f"pg_host_collwr_r{self.rank}",
                ).start()
            self._coll_q.put((job, done, err))
        return done, err

    def p2p_send_async(
        self, peer: int, job: Callable[[], None], fut: Future,
        fail: Callable[[Exception], None],
    ) -> None:
        """Run a p2p write ``job`` on ``peer``'s writer thread, not the
        dispatch thread: symmetric send/send between two ranks would block
        both dispatch threads in sendall on full TCP buffers, with the
        matching receives queued behind them. ``fut`` resolves when the job
        ends; ``fail`` sees its error first."""

        def _writer(wq: "queue.Queue") -> None:
            while True:
                item = wq.get()
                if item is None:
                    return
                jb, ft, fl = item
                try:
                    jb()
                    ft.set_result(None)
                except BaseException as e:  # noqa: BLE001 - handed to the waiter
                    err = e if isinstance(e, Exception) else RuntimeError(str(e))
                    fl(err)
                    try:
                        ft.set_exception(err)
                    except RuntimeError:
                        pass

        with self._lock:
            if self.aborted:
                raise RuntimeError("communicator aborted")
            q = self._p2p_queues.get(peer)
            if q is None:
                q = queue.Queue()
                self._p2p_queues[peer] = q
                threading.Thread(
                    target=_writer, args=(q,), daemon=True,
                    name=f"pg_host_p2p_r{self.rank}_to{peer}",
                ).start()
            # under the lock abort's sentinels are posted with: a job never
            # lands behind one and leaves its future unresolved
            q.put((job, fut, fail))

    def exchange(self, payloads: Dict[int, Any]) -> Dict[int, Any]:
        """Send ``payloads[r]`` to each rank r and receive one object from
        every peer: the writer worker streams the sends while this thread
        drains the receives."""

        def _writes() -> None:
            for peer in sorted(payloads):
                if peer != self.rank:
                    self.send_to(peer, payloads[peer])

        done, err = self.submit_write(_writes)
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
            # jobs queued before the sentinel run first and fail on the
            # closed sockets, so their futures resolve
            for q in self._p2p_queues.values():
                q.put(None)
            if self._coll_q is not None:
                self._coll_q.put(None)
            for s in list(self.peers.values()) + [self._listener]:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass


# Payloads at or above this take the bandwidth-optimal ring; below it the
# full-mesh exchange wins on latency (one round-trip vs 2*(world-1)).
_RING_MIN_BYTES = 64 * 1024


def _ring_step(comm: _Comm, right: int, left: int, send_buf: Any, recv_buf: Any) -> None:
    """One ring hop: stream our segment to the right neighbour (on the
    collective writer: both sides send first) while draining the left
    neighbour's into ``recv_buf``."""
    done, err = comm.submit_write(lambda: comm.send_raw(right, send_buf))
    comm.recv_raw_into(left, recv_buf)
    done.wait()
    if err:
        raise err[0]


def _ring_allreduce(comm: _Comm, leaves: List[Any], op: ReduceOp) -> List[Any]:
    """Bandwidth-optimal allreduce: ring reduce-scatter + ring allgather,
    each rank moving 2*(world-1)/world of the payload, in raw frames
    straight out of the flat working buffer.

    Leaves are packed per dtype into one flat buffer each (ndarrays in
    numpy, bf16 in a CPU torch tensor), split into ``world`` segments and
    unpacked at the end. As ``_reduce_np``: sums in the input dtype (bf16
    rounded at each add), AVG divides by world at the end."""
    world, rank = comm.world, comm.rank
    right, left = (rank + 1) % world, (rank - 1) % world
    out: List[Any] = [None] * len(leaves)

    groups: Dict[Any, List[int]] = {}
    for i, a in enumerate(leaves):
        groups.setdefault(a.dtype, []).append(i)

    for dtype, idxs in sorted(groups.items(), key=lambda kv: dtype_name(kv[0])):
        flat_len = sum(_numel(leaves[i]) for i in idxs)
        seg_len = max(1, -(-flat_len // world))
        if isinstance(dtype, torch.dtype):
            buf = torch.zeros(seg_len * world, dtype=dtype)
            recv_buf = torch.empty(seg_len, dtype=dtype)
        else:
            buf = np.zeros(seg_len * world, dtype)
            recv_buf = np.empty(seg_len, dtype)
        ofs = 0
        for i in idxs:
            n = _numel(leaves[i])
            buf[ofs:ofs + n] = leaves[i].reshape(-1)
            ofs += n
        segs = buf.reshape(world, seg_len)

        # reduce-scatter: after world-1 hops this rank holds the fully
        # reduced segment (rank+1) % world
        for step in range(world - 1):
            s_idx = (rank - step) % world
            r_idx = (rank - step - 1) % world
            _ring_step(comm, right, left, segs[s_idx], recv_buf)
            _accum(op, segs[r_idx], recv_buf)

        # allgather: circulate the reduced segments
        for step in range(world - 1):
            s_idx = (rank + 1 - step) % world
            r_idx = (rank - step) % world
            _ring_step(comm, right, left, segs[s_idx], segs[r_idx])

        if op == ReduceOp.AVG:
            if isinstance(buf, np.ndarray) and np.issubdtype(buf.dtype, np.integer):
                buf = buf / world  # float result, matching _reduce_np
            else:
                buf /= world

        ofs = 0
        for i in idxs:
            n = _numel(leaves[i])
            # independent copies, as the exchange path returns
            piece = buf[ofs:ofs + n].reshape(leaves[i].shape)
            out[i] = piece.clone() if isinstance(piece, torch.Tensor) else piece.copy()
            ofs += n
    return out


def _numel(buf: Any) -> int:
    return buf.numel() if isinstance(buf, torch.Tensor) else buf.size


class _LinkFailure(Exception):
    """One ring hop's link is dead; carries the (lo, hi) rank pair."""

    def __init__(self, a: int, b: int) -> None:
        self.pair = (min(a, b), max(a, b))
        super().__init__(f"ring link {self.pair[0]}<->{self.pair[1]} failed")


def _greedy_order(world: int, dead: set) -> Optional[List[int]]:
    order = [0]
    rest = list(range(1, world))
    while rest:
        nxt = next((r for r in rest if frozenset((order[-1], r)) not in dead), None)
        if nxt is None:
            return None
        order.append(nxt)
        rest.remove(nxt)
    return order


def _ring_order(world: int, dead: set) -> Optional[List[int]]:
    """Deterministic rank order whose ring adjacencies (wraparound
    included) avoid every dead link; every rank computes it from the same
    dead set, so the re-formed ring needs no coordination round. None when
    there is none (world 2 with its only link dead)."""
    if not dead:
        return list(range(world))

    def _ok(order: Sequence[int]) -> bool:
        return all(
            frozenset((order[i], order[(i + 1) % world])) not in dead
            for i in range(world)
        )

    if _ok(range(world)):
        return list(range(world))
    if world <= 8:
        # rotations of a cycle are the same ring: pin rank 0 first
        for perm in itertools.permutations(range(1, world)):
            if _ok([0, *perm]):
                return [0, *perm]
        return None
    order = _greedy_order(world, dead)
    return order if order is not None and _ok(order) else None


def _chain_order(world: int, dead: set) -> Optional[List[int]]:
    """Hamiltonian path over healthy links: the fallback when the dead set
    breaks every cycle but not every path (any dead link at world 3)."""

    def _ok(order: Sequence[int]) -> bool:
        return all(
            frozenset((order[i], order[i + 1])) not in dead for i in range(world - 1)
        )

    if _ok(range(world)):
        return list(range(world))
    if world <= 8:
        for perm in itertools.permutations(range(world)):
            if perm[0] > perm[-1]:
                continue  # a path equals its reverse: one canonical form
            if _ok(perm):
                return list(perm)
        return None
    return _greedy_order(world, dead)


def _flood_reroute(comm: _Comm, left: int, right: int, seq: int, attempt: int, pair) -> None:
    """Best-effort signal of a dead link to both ring neighbours; each rank
    that learns of it forwards before restarting, so it chains rightward
    and unblocks every rank's receive. Send failures are swallowed."""
    msg = ("creroute", seq, attempt, (min(pair), max(pair)))
    for nb in {left, right}:
        if nb == comm.rank:
            continue
        try:
            comm.send_to(nb, msg)
        except Exception:  # noqa: BLE001 - best-effort by design
            pass


def _drain_stale_frames(
    comm: _Comm, skip_peer: int, seq: int, attempt: int, quiet_s: float = 0.05
) -> None:
    """At the start of a re-routed attempt, sweep every peer socket but
    the new left (whose stale frames the hop receive handles) of the
    aborted attempt's frames, which may also unblock a peer's writer. A
    re-route signal of this attempt found here raises _LinkFailure."""
    for peer in sorted(comm.peers):
        if peer in (skip_peer, comm.rank):
            continue
        sock = comm.peers[peer]
        try:
            old = sock.gettimeout()
        except OSError:
            continue
        try:
            while True:
                sock.settimeout(quiet_s)
                try:
                    hdr = comm.recv_from(peer)
                except OSError:
                    break  # quiet (or dead) socket: nothing to drain
                if not (isinstance(hdr, tuple) and len(hdr) == 4):
                    raise RuntimeError(f"compressed ring desync draining rank {peer}: {hdr!r}")
                tag, h_seq, h_attempt, rest = hdr
                stale = h_seq < seq or (h_seq == seq and h_attempt < attempt)
                if tag == "cseg" and stale:
                    sock.settimeout(old)  # the body frames follow
                    comm.recv_raw_discard(peer)
                    comm.recv_raw_discard(peer)
                    continue
                if tag == "creroute":
                    if stale:
                        continue
                    raise _LinkFailure(*rest)
                raise RuntimeError(
                    f"compressed ring desync draining rank {peer}: "
                    f"tag={tag!r} seq={h_seq} attempt={h_attempt}"
                )
        finally:
            try:
                sock.settimeout(old)
            except OSError:
                pass


def _recv_compressed_hop(
    comm: _Comm, left: int, seq: int, attempt: int, hop: int,
    out_q: np.ndarray, out_s: np.ndarray,
) -> None:
    """Receive one compressed-ring hop (header, codes and scales frames),
    draining stale frames of aborted attempts and turning re-route signals
    into _LinkFailure."""
    while True:
        hdr = comm.recv_from(left)
        if not (isinstance(hdr, tuple) and len(hdr) == 4):
            raise RuntimeError(f"unexpected frame on compressed ring: {hdr!r}")
        tag, h_seq, h_attempt, rest = hdr
        stale = h_seq < seq or (h_seq == seq and h_attempt < attempt)
        if tag == "cseg":
            if stale:
                comm.recv_raw_discard(left)
                comm.recv_raw_discard(left)
                continue
            if h_seq != seq or h_attempt != attempt or rest != hop:
                raise RuntimeError(
                    f"compressed ring desync: got seq={h_seq} attempt={h_attempt} "
                    f"hop={rest}, expected seq={seq} attempt={attempt} hop={hop}"
                )
            comm.recv_raw_into(left, out_q)
            comm.recv_raw_into(left, out_s)
            return
        if tag == "creroute":
            if stale:
                continue  # duplicate of an already-handled flood
            raise _LinkFailure(*rest)
        raise RuntimeError(f"unexpected compressed ring tag {tag!r}")


class _HopCodec:
    """The arithmetic of a compressed ring's hops for one wire: decode a
    slab of codes to f32, sum, recode. A wire coded on a card keeps it
    there (``fused_dequantize_fp8`` and the host-rule quantize kernel; only
    codes and scales cross the host); any other runs the host codec in
    numpy. Both give the reference's bits."""

    def __init__(self, wire: CompressedWire) -> None:
        self.device = on_card(wire)
        self._quantize, self._dequantize = codec(wire.mode)

    def empty(self, shape: Tuple[int, ...]) -> Any:
        if self.device is None:
            return np.empty(shape, np.float32)
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def host_empty(self, shape: Tuple[int, ...], dtype: torch.dtype) -> np.ndarray:
        """A host buffer for codes or scales; page-locked when they go on
        to (or come from) the card."""
        return host_empty(shape, dtype, pinned=self.device is not None)

    def decode(self, q: np.ndarray, s: np.ndarray, n: int) -> Any:
        if self.device is None:
            return self._dequantize(q, s, n, np.float32)
        return decode_fp8_on_card(q, s, n, self.device)

    def encode(self, x: Any, row: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.device is None:
            q, s, _ = self._quantize(x, row=row)
        else:
            q, s, _ = encode_fp8_on_card(x)
        return q, np.ascontiguousarray(s, dtype=np.float32)

    @staticmethod
    def divide_(x: Any, world: int) -> None:
        if isinstance(x, torch.Tensor):
            x.copy_(true_divide(x, world))
        else:
            x /= world


def _compressed_ring_pass(
    comm: _Comm, wire: CompressedWire, hc: _HopCodec, Q: np.ndarray, S: np.ndarray,
    rows: int, seg_rows: int, op: ReduceOp, order: List[int], seq: int, attempt: int,
) -> CompressedWire:
    """One attempt of the compressed ring over ``order``.

    Reduce-scatter hops carry compressed segments: each decodes the
    incoming segment, adds it in f32 to this rank's own (own first), and
    recodes the sum for the next hop (hop 0 forwards the original codes).
    The allgather circulates the reduced segments verbatim. Restart-safe:
    all state derives from the immutable input codes (Q, S)."""
    world = len(order)
    pos = order.index(comm.rank)
    right = order[(pos + 1) % world]
    left = order[(pos - 1) % world]
    row = int(wire.row)
    seg_elems = seg_rows * row

    if attempt > 0:
        _drain_stale_frames(comm, left, seq, attempt)

    acc = hc.empty((world, seg_elems))

    def _own_slab(j: int) -> Any:
        return hc.decode(Q[j * seg_rows:(j + 1) * seg_rows],
                         S[j * seg_rows:(j + 1) * seg_rows], seg_elems)

    recv_q = hc.host_empty((seg_rows, row), torch.uint8)
    recv_s = hc.host_empty((seg_rows,), torch.float32)
    hop = 0

    def _send_recv(send_q: np.ndarray, send_s: np.ndarray,
                   out_q: np.ndarray = recv_q, out_s: np.ndarray = recv_s) -> None:
        nonlocal hop
        this_hop = hop
        for a, b in ((comm.rank, right), (left, comm.rank)):
            try:
                comm.check_link_fault(a, b, this_hop)
            except ConnectionError as e:
                _flood_reroute(comm, left, right, seq, attempt, (a, b))
                raise _LinkFailure(a, b) from e
        hdr = ("cseg", seq, attempt, this_hop)

        done, err = comm.submit_write(lambda: comm.send_hop(right, hdr, send_q, send_s))
        try:
            _recv_compressed_hop(comm, left, seq, attempt, this_hop, out_q, out_s)
        except _LinkFailure as lf:
            # forward the flood before restarting so it keeps chaining
            _flood_reroute(comm, left, right, seq, attempt, lf.pair)
            raise
        except (ConnectionError, OSError, ValueError) as e:
            _flood_reroute(comm, left, right, seq, attempt, (left, comm.rank))
            raise _LinkFailure(left, comm.rank) from e
        finally:
            done.wait()
        if err:
            _flood_reroute(comm, left, right, seq, attempt, (comm.rank, right))
            raise _LinkFailure(comm.rank, right) from err[0]
        hop += 1

    # reduce-scatter: after world-1 hops this rank holds the fully reduced
    # chunk (pos+1) % world in f32
    for step in range(world - 1):
        s_idx = (pos - step) % world
        r_idx = (pos - step - 1) % world
        if step == 0:
            sq = Q[s_idx * seg_rows:(s_idx + 1) * seg_rows]
            ss = S[s_idx * seg_rows:(s_idx + 1) * seg_rows]
        else:
            sq, ss = hc.encode(acc[s_idx], row)
        _send_recv(sq, ss)
        acc[r_idx] = _own_slab(r_idx)
        acc[r_idx] += hc.decode(recv_q, recv_s, seg_elems)

    own = (pos + 1) % world
    if op == ReduceOp.AVG:
        hc.divide_(acc[own], world)
    q_own, s_own = hc.encode(acc[own], row)

    Qr = hc.host_empty((world, seg_rows, row), torch.uint8)
    Sr = hc.host_empty((world, seg_rows), torch.float32)
    Qr[own] = q_own
    Sr[own] = s_own

    # allgather: circulate the reduced compressed segments verbatim, each
    # received straight into its place
    for step in range(world - 1):
        s_idx = (pos + 1 - step) % world
        r_idx = (pos - step) % world
        _send_recv(Qr[s_idx], Sr[s_idx], Qr[r_idx], Sr[r_idx])

    # Qr is this attempt's own: no copy unless padding rows must go
    payload, scales = Qr.reshape(world * seg_rows, row), Sr.reshape(-1)
    if rows != world * seg_rows:
        payload, scales = payload[:rows].copy(), scales[:rows].copy()
    return wire._replace(payload=payload, scales=scales)


def _compressed_chain_pass(
    comm: _Comm, wire: CompressedWire, hc: _HopCodec, Q: np.ndarray, S: np.ndarray,
    rows: int, op: ReduceOp, order: List[int], seq: int, attempt: int,
) -> CompressedWire:
    """The open-chain attempt, for a dead-link set that leaves no ring but
    a Hamiltonian path: the reduce sweeps head to tail (each hop decodes,
    adds in f32, recodes the whole buffer), the tail finishes the op and
    the reduced codes ride back tail to head verbatim. Hop labels are
    global chain positions, so both ends of a hop agree."""
    world = len(order)
    pos = order.index(comm.rank)
    # comm.rank stands for "no neighbour": _flood_reroute skips it
    left = order[pos - 1] if pos > 0 else comm.rank
    right = order[pos + 1] if pos < world - 1 else comm.rank
    row = int(wire.row)
    pad_rows = Q.shape[0]

    if attempt > 0:
        _drain_stale_frames(comm, left if pos > 0 else right, seq, attempt)

    recv_q = np.empty((pad_rows, row), np.uint8)
    recv_s = np.empty(pad_rows, np.float32)

    def _checked(a: int, b: int, hop: int) -> None:
        try:
            comm.check_link_fault(a, b, hop)
        except ConnectionError as e:
            _flood_reroute(comm, left, right, seq, attempt, (a, b))
            raise _LinkFailure(a, b) from e

    def _send(peer: int, hop: int, sq: np.ndarray, ss: np.ndarray) -> None:
        _checked(comm.rank, peer, hop)
        hdr = ("cseg", seq, attempt, hop)

        done, err = comm.submit_write(lambda: comm.send_hop(peer, hdr, sq, ss))
        done.wait()
        if err:
            _flood_reroute(comm, left, right, seq, attempt, (comm.rank, peer))
            raise _LinkFailure(comm.rank, peer) from err[0]

    def _recv(peer: int, hop: int) -> None:
        _checked(peer, comm.rank, hop)
        try:
            _recv_compressed_hop(comm, peer, seq, attempt, hop, recv_q, recv_s)
        except _LinkFailure as lf:
            _flood_reroute(comm, left, right, seq, attempt, lf.pair)
            raise
        except (ConnectionError, OSError, ValueError) as e:
            _flood_reroute(comm, left, right, seq, attempt, (peer, comm.rank))
            raise _LinkFailure(peer, comm.rank) from e

    # reduce sweep head -> tail
    acc = None
    if pos > 0:
        _recv(left, pos - 1)
        acc = hc.decode(Q, S, Q.size)
        acc += hc.decode(recv_q, recv_s, Q.size)
    if pos < world - 1:
        if acc is None:  # the head forwards its original codes unrounded
            sq, ss = Q, S
        else:
            sq, ss = hc.encode(acc, row)
        _send(right, pos, sq, ss)
        # broadcast sweep tail -> head
        _recv(right, (world - 1) + (world - 1 - pos))
        out_q, out_s = recv_q.copy(), recv_s.copy()
    else:
        if op == ReduceOp.AVG:
            hc.divide_(acc, world)
        out_q, out_s = hc.encode(acc, row)
    if pos > 0:
        _send(left, (world - 1) + (world - 1 - (pos - 1)), out_q, out_s)

    return wire._replace(
        payload=out_q.reshape(pad_rows, row)[:rows].copy(),
        scales=out_s.reshape(-1)[:rows].copy(),
    )


def _ring_allreduce_compressed(
    comm: _Comm,
    wire: CompressedWire,
    op: ReduceOp,
    timeout: float = 60.0,
    on_reroute: Optional[Callable[[tuple, int], None]] = None,
) -> CompressedWire:
    """Compressed ring allreduce with mid-collective link failover.

    A hop failure (socket error or injected ``link_faults`` entry) floods a
    re-route signal around the ring, every rank restarts under the
    ``retry.py`` policy (``TORCHFT_RETRY_*``), and the ring re-forms over a
    deterministic order that avoids every known-dead link, or an open chain
    where no ring exists. ``on_reroute(pair, attempt)`` fires once per
    re-route on the ranks that initiated or learned of it."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"compressed allreduce supports SUM and AVG, got {op}")
    hc = _HopCodec(wire)
    world = comm.world
    seq = comm.cring_seq
    comm.cring_seq = seq + 1

    scales = np.asarray(wire.scales, dtype=np.float32).reshape(-1)
    rows = int(scales.size)
    row = int(wire.row)
    seg_rows = max(1, -(-rows // world))
    pad_rows = seg_rows * world
    # the codes, read only, padded with zero rows (scale 1) to a whole
    # segment per rank: a copy only when there is padding to add
    Q = np.asarray(wire.payload).reshape(rows, row)
    S = scales
    if pad_rows != rows:
        Q = np.concatenate([Q, np.zeros((pad_rows - rows, row), np.uint8)])
        S = np.concatenate([S, np.ones(pad_rows - rows, np.float32)])

    # start from the links this generation already saw die
    dead: set = set(comm.cring_dead)
    state = {"attempt": 0}

    def _attempt(_remaining: float) -> CompressedWire:
        order = _ring_order(world, dead)
        chain = None
        if order is None:
            chain = _chain_order(world, dead)
            if chain is None:
                raise RuntimeError(
                    f"compressed ring cannot re-form at world={world}: dead links "
                    f"{sorted(tuple(sorted(d)) for d in dead)} leave no ring or chain"
                )
        try:
            if order is not None:
                return _compressed_ring_pass(
                    comm, wire, hc, Q, S, rows, seg_rows, op, order, seq, state["attempt"]
                )
            return _compressed_chain_pass(
                comm, wire, hc, Q, S, rows, op, chain, seq, state["attempt"]
            )
        except _LinkFailure as lf:
            dead.add(frozenset(lf.pair))
            comm.cring_dead.add(frozenset(lf.pair))
            state["attempt"] += 1
            if on_reroute is not None:
                try:
                    on_reroute(lf.pair, state["attempt"])
                except Exception:  # noqa: BLE001 - an observer must not kill the op
                    logger.exception("re-route observer failed")
            raise

    return retry_call(
        _attempt, RetryPolicy.from_env(), timeout=timeout, retryable=(_LinkFailure,)
    )


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
            # "p2p" or "collective", fixed by the first op: p2p writes ride
            # per-peer writer threads, collectives the dispatch and ring
            # threads, and mixing them could reorder frames on a socket
            self.mode: Optional[str] = None
            self._mode_lock = threading.Lock()
            self.thread: Optional[threading.Thread] = None

        def claim_mode(self, mode: str) -> None:
            with self._mode_lock:
                if self.mode is None:
                    self.mode = mode
                elif self.mode != mode:
                    raise RuntimeError(
                        f"ProcessGroupHost generation already used for {self.mode} "
                        "ops; p2p and collective ops cannot mix on one generation "
                        "(frame order): give the checkpoint transport its own "
                        "process group"
                    )

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
        # injected link faults, shared with every generation's _Comm so a
        # fault armed before or after configure reaches the live mesh
        self._link_faults: Dict[frozenset, int] = {}
        self._reroute_observer: Optional[Callable[[tuple, int], None]] = None
        # counters of retired generations: wire_stats() stays monotonic
        self._wire_totals = {"bytes_sent": 0, "bytes_recv": 0, "busy_s": 0.0}

    # -- fault injection and wire counters ---------------------------------
    def inject_link_fault(self, src: int, dst: int, at_hop: int = 0) -> None:
        """Sever ring link (src, dst) from hop ``at_hop`` of every
        compressed collective on this PG, inside the collective, so the
        ring's re-route is what recovers. Dead until clear_link_faults."""
        self._link_faults[frozenset((int(src), int(dst)))] = int(at_hop)

    def clear_link_faults(self) -> None:
        self._link_faults.clear()

    def set_reroute_observer(self, fn: Optional[Callable[[tuple, int], None]]) -> None:
        """``fn(dead_pair, attempt)`` fires on every mid-collective
        re-route."""
        self._reroute_observer = fn

    def wire_stats(self) -> Dict[str, float]:
        """Cumulative transport counters over every generation of this PG:
        frame bytes sent and received, and ``busy_s``, the seconds the
        sender spent inside sendall (``bytes_sent / busy_s`` is the wire's
        delivered rate)."""
        with self._lock:
            out = dict(self._wire_totals)
            gen = self._gen
        if gen is not None:
            out["bytes_sent"] += gen.comm.bytes_sent
            out["bytes_recv"] += gen.comm.bytes_recv
            out["busy_s"] += gen.comm.wire_busy_s
        return out

    # -- lifecycle ----------------------------------------------------------
    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        comm = _Comm(replica_rank, replica_world_size, store_addr, quorum_id, self._timeout)
        comm.link_faults = self._link_faults
        gen = ProcessGroupHost._Generation(comm)
        with self._lock:
            old, self._gen = self._gen, gen
            self._rank = replica_rank
            self._world = replica_world_size
            if old is not None:
                self._wire_totals["bytes_sent"] += old.comm.bytes_sent
                self._wire_totals["bytes_recv"] += old.comm.bytes_recv
                self._wire_totals["busy_s"] += old.comm.wire_busy_s
        if old is not None:
            old.abort()
            old.queue.put(None)
        gen.thread = threading.Thread(
            target=self._dispatch_loop, args=(gen,), daemon=True,
            name=f"pg_host_dispatch_r{replica_rank}",
        )
        gen.thread.start()

    def abort(self) -> None:
        with self._lock:
            gen = self._gen
        if gen is not None:
            gen.abort()
            log_error_event(source="process_group", event="abort", replica_rank=self._rank,
                            replica_world_size=self._world)
            # the abort's postmortem: the ring holds the collectives before it
            _fr.recorder.record("pg_abort", rank=self._rank, world=self._world)
            _fr.recorder.dump(reason="pg_abort")

    def shutdown(self) -> None:
        with self._lock:
            gen, self._gen = self._gen, None
        if gen is not None:
            gen.abort()
            gen.queue.put(None)
            # the aborted mesh fails an op in flight at once; past the join
            # no thread of this PG holds it (or what its observers hold)
            if gen.thread is not None and gen.thread is not threading.current_thread():
                gen.thread.join(timeout=self._timeout)

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

    def _live_generation(self, mode: str) -> "ProcessGroupHost._Generation":
        """The current generation, claimed for ``mode``; raises when the
        group is unconfigured or errored. Call under ``_lock``."""
        gen = self._gen
        if gen is None:
            raise RuntimeError("process group is not configured")
        if gen.error is not None:
            raise gen.error
        gen.claim_mode(mode)
        return gen

    def _submit(self, fn: Callable[[_Comm], Any], name: str = "op",
                mode: str = "collective") -> Work:
        _fr.recorder.record("collective", op=name, rank=self._rank, world=self._world)
        with self._lock:
            gen = self._live_generation(mode)
            fut: Future[Any] = Future()
            gen.queue.put((fn, fut))
            return FutureWork(fut)

    def allreduce(self, arrays, op=ReduceOp.SUM):
        host = [_to_host(a) for a in arrays]

        def _run(comm: _Comm):
            # a compressed bucket rides the self-healing ring: the only path
            # that recodes per hop and re-routes around a dead link
            if len(host) == 1 and is_compressed_wire(host[0]):
                wire = host[0]
                if comm.world == 1:
                    return [wire._replace(payload=wire.payload.copy(),
                                          scales=wire.scales.copy())]
                return [_ring_allreduce_compressed(
                    comm, wire, op, timeout=self._timeout,
                    on_reroute=self._reroute_observer,
                )]
            if comm.world == 1:
                return [_copy_payload(h) for h in host]
            if all(isinstance(h, _BUFFERS) for h in host) and (
                sum(_nbytes(h) for h in host) >= _RING_MIN_BYTES
            ):
                return _ring_allreduce(comm, host, op)
            gathered = comm.exchange({r: host for r in range(comm.world)})
            return [
                _reduce_np(op, [gathered[r][i] for r in range(comm.world)])
                for i in range(len(host))
            ]

        return self._submit(_run, "allreduce")

    def allgather(self, arrays):
        host = [_to_host(a) for a in arrays]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [[_copy_payload(h) for h in host]]
            gathered = comm.exchange({r: host for r in range(comm.world)})
            return [gathered[r] for r in range(comm.world)]

        return self._submit(_run, "allgather")

    def broadcast(self, arrays, root=0):
        host = [_to_host(a) for a in arrays]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [_copy_payload(h) for h in host]
            if comm.rank == root:
                for peer in range(comm.world):
                    if peer != comm.rank:
                        comm.send_to(peer, host)
                # each peer acks: a small payload to a dead peer can land in
                # the kernel's buffer and "succeed", so without the ack the
                # root would not see the failure (the reference's contract)
                for peer in range(comm.world):
                    if peer != comm.rank:
                        ack = comm.recv_from(peer)
                        if ack != ("bcast_ack", peer):
                            raise RuntimeError(f"bad broadcast ack: {ack!r}")
                return host
            out = comm.recv_from(root)
            comm.send_to(root, ("bcast_ack", comm.rank))
            return out

        return self._submit(_run, "broadcast")

    def alltoall(self, input_chunks):
        host = [_to_host(a) for a in input_chunks]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [_copy_payload(h) for h in host]
            if len(host) != comm.world:
                raise ValueError(f"alltoall needs {comm.world} chunks, got {len(host)}")
            gathered = comm.exchange({r: host[r] for r in range(comm.world)})
            return [gathered[r] for r in range(comm.world)]

        return self._submit(_run, "alltoall")

    def reduce_scatter(self, input_chunks, op=ReduceOp.SUM):
        """``input_chunks[r]`` is this rank's contribution to rank r; the
        future resolves to this rank's reduced chunk (reference ``:1573``)."""
        host = [[_to_host(a) for a in chunk] for chunk in input_chunks]

        def _run(comm: _Comm):
            if comm.world == 1:
                return [_copy_payload(h) for h in host[0]]
            if len(host) != comm.world:
                raise ValueError(f"reduce_scatter needs {comm.world} chunks, got {len(host)}")
            gathered = comm.exchange({r: host[r] for r in range(comm.world)})
            return [_reduce_np(op, [gathered[r][i] for r in range(comm.world)])
                    for i in range(len(host[0]))]

        return self._submit(_run, "reduce_scatter")

    # -- point to point -----------------------------------------------------
    streams_raw_frames = True

    def send(self, arrays, dst, tag=0):
        host = [_stage_p2p(a) for a in arrays]
        _fr.recorder.record("collective", op="send", rank=self._rank, world=self._world)
        with self._lock:
            gen = self._live_generation("p2p")
        fut: Future[Any] = Future()
        timeout = self._timeout

        def job() -> None:
            # its own watchdog: the job runs on the peer's writer thread
            with context_timeout(gen.abort, timeout):
                comm = gen.comm
                if all(isinstance(h, _BUFFERS) for h in host) and (
                    sum(_nbytes(h) for h in host) >= _RING_MIN_BYTES
                ):
                    # a small pickled header of dtypes and shapes, then each
                    # buffer's bytes straight from memory
                    metas = [(dtype_name(h.dtype), tuple(h.shape)) for h in host]
                    comm.send_to(dst, ("p2p_raw", tag, metas))
                    for h in host:
                        comm.send_raw(dst, h)
                else:
                    comm.send_to(dst, ("p2p", tag, host))

        def fail(e: Exception) -> None:
            gen.error = gen.error or e

        gen.comm.p2p_send_async(dst, job, fut, fail)
        return FutureWork(fut)

    def recv(self, src, tag=0):
        return self.recv_into([], src, tag)

    def recv_into(self, buffers, src, tag=0):
        """``recv`` whose raw frames land in ``buffers``: entry i of the
        result IS ``buffers[i]`` when that buffer can absorb the frame
        (``can_absorb``, contiguous), else a fresh host array (pickled
        messages, mismatched buffers, more arrays than buffers). A CUDA
        buffer receives through page-locked host memory into its own
        storage."""
        buffers = list(buffers)

        def _run(comm: _Comm):
            from torchft_tpu_torch.checkpointing._serialization import can_absorb

            kind, got_tag, payload = comm.recv_from(src)
            if got_tag != tag:
                raise RuntimeError(f"p2p tag {got_tag} from rank {src}, expected {tag}")
            if kind == "p2p":
                return payload
            if kind != "p2p_raw":
                raise RuntimeError(f"unexpected p2p frame {kind!r} from rank {src}")
            out = []
            for i, (dtype, shape) in enumerate(payload):
                target = buffers[i] if i < len(buffers) else None
                if not can_absorb(target, shape, dtype, require_contiguous=True):
                    target = _host_alloc(dtype, shape)
                if isinstance(target, torch.Tensor) and target.is_cuda:
                    staged = host_empty((target.numel() * target.element_size(),),
                                        torch.uint8, pinned=True)
                    comm.recv_raw_into(src, staged)
                    target.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(staged))
                else:
                    comm.recv_raw_into(src, target)
                out.append(target)
            return out

        return self._submit(_run, "recv", mode="p2p")


# ---------------------------------------------------------------------------
# Subprocess-isolated ("Baby") process groups
# ---------------------------------------------------------------------------


class _PipeTensor:
    """A CPU tensor on a Baby process group's pipe, as a numpy array of its
    bits. ``import torch`` registers torch's reductions on the pipe's
    pickler, which would send a tensor as a shared-memory file descriptor
    (a heal's worth of ``/dev/shm`` segments pinned in both processes);
    numpy crosses as bytes, as the reference's host arrays do."""

    __slots__ = ("bits", "dtype")

    def __init__(self, t: torch.Tensor) -> None:
        t = t.detach().contiguous()
        self.dtype = dtype_name(t.dtype)
        # numpy has no bf16: its 16-bit patterns ride as int16
        self.bits = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.bits)
        return t.view(torch.bfloat16) if self.dtype == "bfloat16" else t


def _pipe_out(x: Any) -> Any:
    """``x`` with every CPU tensor in it (lists, tuples, dicts) wrapped for
    the pipe."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            raise TypeError("a CUDA tensor reached a Baby process group's pipe: its child "
                            "never touches the card")
        return _PipeTensor(x)
    if isinstance(x, CompressedWire):
        if x.device is not None:
            raise TypeError(f"a wire coded on {x.device} reached a Baby process group: its "
                            "child never touches the card")
        return x
    if isinstance(x, list):
        return [_pipe_out(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_pipe_out(v) for v in x)
    if isinstance(x, dict):
        return {k: _pipe_out(v) for k, v in x.items()}
    return x


def _pipe_in(x: Any) -> Any:
    """The inverse of ``_pipe_out``."""
    if isinstance(x, _PipeTensor):
        return x.tensor()
    if isinstance(x, CompressedWire):
        return x
    if isinstance(x, list):
        return [_pipe_in(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_pipe_in(v) for v in x)
    if isinstance(x, dict):
        return {k: _pipe_in(v) for k, v in x.items()}
    return x


def _call_quietly(fn: Any) -> None:
    try:
        fn()
    except Exception:  # noqa: BLE001 - the abort path does its best
        pass


def _baby_worker(
    pg_class: type,
    store_addr: str,
    rank: int,
    world: int,
    quorum_id: int,
    timeout: float,
    req_conn: Any,
    fut_conn: Any,
    abort_cell: Optional[list] = None,
) -> None:
    """The child's loop of a Baby process group (reference ``:1693``):
    configure the real process group, then serve the parent's
    ``("func", op_id, name, args, kwargs)`` requests, posting each op's
    result or exception on the future pipe as it completes. Module level,
    so the spawn context pickles it by name."""
    from torchft_tpu_torch.multiprocessing import _MonitoredPipe

    req, fut_pipe = _MonitoredPipe(req_conn), _MonitoredPipe(fut_conn)

    def _post(op_id: Any, payload: Any, kind: str) -> None:
        try:
            fut_pipe.send((op_id, kind, _pipe_out(payload) if kind == "result" else payload))
        except (OSError, EOFError, BrokenPipeError):
            pass  # the parent is gone: the next recv ends the loop
        except Exception as e:  # noqa: BLE001 - e.g. a payload that does not pickle
            # never lose an op: a picklable error resolves its future
            try:
                fut_pipe.send((op_id, "exception",
                               RuntimeError(f"baby worker could not ship {kind}: {e!r}")))
            except (OSError, EOFError, BrokenPipeError):
                pass

    try:
        pg = pg_class(timeout=timeout)
        pg.configure(store_addr, rank, world, quorum_id=quorum_id)
    except Exception as e:  # noqa: BLE001 - the parent's configure raises it
        _post("init", e, "exception")
        return
    if abort_cell is not None:
        # the parent's way to the inner group's abort under DummyContext,
        # whose "child" is a thread: kill() cannot stop it, and closing the
        # request pipe ends only this loop, not an op wedged in the inner
        # group. Under spawn this is the child's own copy (kill() works)
        abort_cell.append(pg.abort)
    _post("init", None, "result")

    while True:
        try:
            cmd = req.recv(None)
        except (EOFError, OSError):
            break
        if cmd is None:
            break
        if cmd[0] == "func":
            _, op_id, name, args, kwargs = cmd
            try:
                work = getattr(pg, name)(*_pipe_in(args), **kwargs)
            except Exception as e:  # noqa: BLE001 - resolves the op's future
                _post(op_id, e, "exception")
                continue

            def _done(f: Future, op_id: Any = op_id) -> None:
                exc = f.exception()
                if exc is not None:
                    if not isinstance(exc, Exception):
                        exc = RuntimeError(str(exc))
                    _post(op_id, exc, "exception")
                else:
                    _post(op_id, f.value(), "result")

            work.get_future().add_done_callback(_done)
    pg.shutdown()


class ProcessGroupBaby(ProcessGroup):
    """The real process group in a child process, so a hung or wedged
    communicator can be killed without killing the trainer (reference
    ``ProcessGroupBaby``, ``:1776``).

    ``ctx`` is a ``multiprocessing`` context, ``spawn`` by default: the
    child is a fresh interpreter that imports this module and never the
    trainer's CUDA state (it imports no module that initializes the card).
    ``multiprocessing_dummy_context.DummyContext()`` runs the child in a
    thread instead, for fast tests. Every ``configure`` starts a new
    generation: a new child and its two pipes, the old ones torn down. A
    timeout or a dead child fails every outstanding op and sets
    ``errored()``; ``abort()`` kills the child (under ``DummyContext`` it
    calls the inner group's ``abort``).

    Tensors cross the pipe as host arrays: ``_to_host`` stages them (a
    CUDA tensor is copied to the host), and CPU tensors (bf16) ride as
    numpy bits (``_PipeTensor``). Results come back on the host, as
    ``ProcessGroupHost``'s do. There is no ``recv_into`` and no raw frame:
    ``PGTransport`` takes its windowed per-leaf wire over a Baby group."""

    PG_CLASS: type = None  # type: ignore[assignment]  # set by subclasses

    class _Gen:
        """One configure() generation: the child, its pipes and the
        outstanding ops."""

        def __init__(self, proc: Any, req: Any, fut: Any,
                     abort_cell: Optional[list] = None) -> None:
            self.proc = proc
            self.req = req
            self.fut_pipe = fut
            self.futures: Dict[int, Future] = {}
            self.lock = threading.Lock()
            self.error: Optional[Exception] = None
            self.stopped = False
            # the inner group's abort, reachable only under DummyContext
            self.abort_cell: list = [] if abort_cell is None else abort_cell

    def __init__(self, timeout: "float | timedelta" = 60.0, ctx: Any = None) -> None:
        super().__init__()
        self.set_timeout(timeout)
        self._ctx = ctx
        self._gen: Optional[ProcessGroupBaby._Gen] = None
        self._rank = 0
        self._world = 1
        self._next_op_id = 0
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        import multiprocessing
        import multiprocessing.connection

        from torchft_tpu_torch.multiprocessing import _MonitoredPipe

        self._teardown(terminal=False)
        ctx = self._ctx if self._ctx is not None else multiprocessing.get_context("spawn")
        req_local, req_remote = ctx.Pipe()
        fut_local, fut_remote = ctx.Pipe()
        abort_cell: list = []
        proc = ctx.Process(
            target=_baby_worker,
            args=(type(self).PG_CLASS, store_addr, replica_rank, replica_world_size, quorum_id,
                  self._timeout, req_remote, fut_remote, abort_cell),
            daemon=True,
            name=f"baby_pg_r{replica_rank}",
        )
        proc.start()
        # the parent drops its copies of the child's ends, so a dead child
        # reads as EOF (a dummy pipe's close signals its peer instead)
        for remote in (req_remote, fut_remote):
            if isinstance(remote, multiprocessing.connection.Connection):
                remote.close()
        gen = ProcessGroupBaby._Gen(proc, _MonitoredPipe(req_local), _MonitoredPipe(fut_local),
                                    abort_cell)
        # the child's configure meets its peers: the op timeout, plus the
        # child's start. On any failure the child and its pipes are reaped:
        # a trainer reconfigures every quorum and must not orphan children
        try:
            op_id, kind, payload = gen.fut_pipe.recv(self._timeout + 30.0)  # type: ignore[misc]
            if op_id != "init":
                raise RuntimeError(f"baby process group child answered {op_id!r} before init")
            if kind == "exception":
                raise payload
        except BaseException:
            gen.stopped = True
            gen.req.close()
            gen.fut_pipe.close()
            proc.kill()
            proc.join(5.0)
            raise
        with self._lock:
            self._gen = gen
            self._rank = replica_rank
            self._world = replica_world_size
        threading.Thread(target=self._future_handler, args=(gen,), daemon=True,
                         name=f"baby_pg_futures_r{replica_rank}").start()

    def _future_handler(self, gen: "ProcessGroupBaby._Gen") -> None:
        """The parent's pump: resolves the parent's futures from the future
        pipe (reference ``_future_handler``)."""
        while True:
            if gen.stopped:
                return
            try:
                if not gen.fut_pipe.poll(0.1):
                    continue
                op_id, kind, payload = gen.fut_pipe.recv(0)  # type: ignore[misc]
            except TimeoutError:
                continue
            except (EOFError, OSError):
                self._fail_gen(gen, gen.error or RuntimeError("baby process group child died"))
                return
            with gen.lock:
                fut = gen.futures.pop(op_id, None)
            if fut is None:
                continue
            try:
                if kind == "exception":
                    gen.error = payload
                    fut.set_exception(payload)
                else:
                    fut.set_result(_pipe_in(payload))
            except RuntimeError:
                pass  # resolved already (an abort)

    def _fail_gen(self, gen: "ProcessGroupBaby._Gen", err: Exception) -> None:
        gen.error = gen.error or err
        with gen.lock:
            outstanding, gen.futures = dict(gen.futures), {}
        for fut in outstanding.values():
            try:
                fut.set_exception(err)
            except RuntimeError:
                pass

    def _teardown(self, terminal: bool) -> None:
        with self._lock:
            gen, self._gen = self._gen, None
        if gen is None:
            return
        gen.stopped = True
        try:
            gen.req.send(None)  # a polite stop, for a thread-backed child
        except (OSError, EOFError, BrokenPipeError):
            pass
        gen.req.close()
        gen.fut_pipe.close()
        gen.proc.kill()
        gen.proc.join(5.0)
        self._fail_gen(gen, RuntimeError(
            "process group shut down" if terminal
            else "process group torn down for reconfiguration"))

    def abort(self) -> None:
        with self._lock:
            gen = self._gen
        if gen is None:
            return
        gen.error = gen.error or RuntimeError("process group aborted")
        gen.stopped = True
        gen.proc.kill()
        gen.req.close()
        gen.fut_pipe.close()
        # under DummyContext the child is a thread: call its inner group's
        # abort, on a thread of its own, since abort() returns promptly
        # even if that one wedges
        for hook in list(gen.abort_cell):
            threading.Thread(target=lambda h=hook: _call_quietly(h), daemon=True,
                             name="baby_pg_inner_abort").start()
        self._fail_gen(gen, gen.error)
        # the child (and its own abort-time dump) is gone: the postmortem
        # is the parent's
        log_error_event(source="baby_process_group", event="abort", replica_rank=self._rank,
                        replica_world_size=self._world)
        _fr.recorder.record("baby_pg_abort", rank=self._rank, world=self._world)
        _fr.recorder.dump(reason="baby_pg_abort")

    def shutdown(self) -> None:
        self._teardown(terminal=True)

    def errored(self) -> Optional[Exception]:
        with self._lock:
            gen = self._gen
        if gen is None:
            return None
        if gen.error is None and not gen.proc.is_alive() and not gen.stopped:
            gen.error = RuntimeError(
                f"baby process group child exited (exitcode={gen.proc.exitcode})")
        return gen.error

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def num_active_work(self) -> int:
        """Ops submitted and not resolved yet."""
        with self._lock:
            gen = self._gen
        if gen is None:
            return 0
        with gen.lock:
            return len(gen.futures)

    # -- dispatch -----------------------------------------------------------
    def _submit(self, name: str, *args: Any, **kwargs: Any) -> Work:
        with self._lock:
            gen = self._gen
            if gen is None:
                raise RuntimeError("process group is not configured")
            if gen.error is not None:
                raise gen.error
            op_id = self._next_op_id
            self._next_op_id += 1
        fut: Future = Future()
        with gen.lock:
            gen.futures[op_id] = fut
        _fr.recorder.record("collective", op=name, rank=self._rank, world=self._world)
        try:
            gen.req.send(("func", op_id, name, _pipe_out(list(args)), kwargs))
        except (OSError, EOFError, BrokenPipeError) as e:
            err = RuntimeError(f"baby process group pipe broken: {e}")
            self._fail_gen(gen, err)
            raise err from e
        # the register/fail race: _fail_gen swaps the table under gen.lock
        # and sets gen.error first, so a future registered after the swap
        # is failed here instead of waiting out its timeout
        if gen.stopped or gen.error is not None:
            with gen.lock:
                orphan = gen.futures.pop(op_id, None)
            if orphan is not None:
                try:
                    orphan.set_exception(gen.error or RuntimeError("process group stopped"))
                except RuntimeError:
                    pass
        return FutureWork(fut)

    # -- collectives --------------------------------------------------------
    def allreduce(self, arrays, op=ReduceOp.SUM):
        return self._submit("allreduce", [_to_host(a) for a in arrays], op)

    def allgather(self, arrays):
        return self._submit("allgather", [_to_host(a) for a in arrays])

    def broadcast(self, arrays, root=0):
        return self._submit("broadcast", [_to_host(a) for a in arrays], root)

    def reduce_scatter(self, input_chunks, op=ReduceOp.SUM):
        return self._submit("reduce_scatter",
                            [[_to_host(a) for a in chunk] for chunk in input_chunks], op)

    def alltoall(self, input_chunks):
        return self._submit("alltoall", [_to_host(a) for a in input_chunks])

    def send(self, arrays, dst, tag=0):
        return self._submit("send", [_to_host(a) for a in arrays], dst, tag)

    def recv(self, src, tag=0):
        return self._submit("recv", src, tag)


class ProcessGroupBabyHost(ProcessGroupBaby):
    """A Baby process group running ``ProcessGroupHost`` in its child (the
    reference's ``ProcessGroupBabyHost``, ``:2092``)."""

    PG_CLASS = ProcessGroupHost


class _ErrorSwallowingWork(Work):
    """A Work whose failure reports the error to its wrapper and resolves
    to a default value instead of raising."""

    def __init__(
        self, pg: "ErrorSwallowingProcessGroupWrapper", work: Work,
        default_fn: Callable[[], Any],
    ) -> None:
        self._future: Future = Future()

        def _transfer(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                self._future.set_result(f.value())
                return
            pg.report_error(exc if isinstance(exc, Exception) else RuntimeError(str(exc)))
            # the default is built only on the error path, and a default
            # that raises fails the future rather than stranding it
            try:
                self._future.set_result(default_fn())
            except Exception as e:  # noqa: BLE001 - resolves the future
                try:
                    self._future.set_exception(e)
                except RuntimeError:
                    pass

        work.get_future().add_done_callback(_transfer)

    def wait(self, timeout: "float | timedelta | None" = None) -> bool:
        self._future.wait(timeout)
        return True

    def get_future(self) -> Future:
        return self._future


class ErrorSwallowingProcessGroupWrapper(ProcessGroup):
    """Swallows collective errors: after the first error every op returns
    its input (host copies) until the next configure, so a replica keeps
    stepping through a dead communicator and the Manager discards the step
    at its vote. For a process group whose configure commits on the main
    thread, the error clears at the commit, when the new communicator is
    live."""

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__()
        self._pg = pg
        self._error: Optional[Exception] = None

    @property
    def device_native(self) -> bool:
        # the Manager reads the data plane's capability off the outermost PG
        return getattr(self._pg, "device_native", False)

    def parent(self) -> ProcessGroup:
        return self._pg

    def error(self) -> Optional[Exception]:
        return self._error

    def report_error(self, e: Exception) -> None:
        self._error = e

    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        self._error = None
        self._pg.configure(store_addr, replica_rank, replica_world_size, quorum_id=quorum_id)

    def prepare_configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        inner = self._pg.prepare_configure(
            store_addr, replica_rank, replica_world_size, quorum_id=quorum_id
        )
        if inner is None:
            self._error = None
            return None

        def commit() -> None:
            inner()
            self._error = None

        return commit

    def abort(self) -> None:
        self._pg.abort()

    def shutdown(self) -> None:
        self._pg.shutdown()

    def errored(self) -> Optional[Exception]:
        return self._error or self._pg.errored()

    def size(self) -> int:
        return self._pg.size()

    def rank(self) -> int:
        return self._pg.rank()

    def set_timeout(self, timeout: "float | timedelta") -> None:
        self._pg.set_timeout(timeout)

    def _guard(self, fn: Callable[[], Work], default_fn: Callable[[], Any]) -> Work:
        """``default_fn`` runs only on the error path: it stages the
        payload to the host."""
        if self._error is not None:
            return DummyWork(default_fn())
        try:
            return _ErrorSwallowingWork(self, fn(), default_fn)
        except Exception as e:  # noqa: BLE001 - the swallow contract
            self.report_error(e)
            return DummyWork(default_fn())

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return self._guard(lambda: self._pg.allreduce(arrays, op),
                           lambda: [_to_host(a) for a in arrays])

    def allgather(self, arrays):
        # one entry per rank, as the op's result
        return self._guard(lambda: self._pg.allgather(arrays),
                           lambda: [[_to_host(a) for a in arrays] for _ in range(self._pg.size())])

    def broadcast(self, arrays, root=0):
        return self._guard(lambda: self._pg.broadcast(arrays, root),
                           lambda: [_to_host(a) for a in arrays])

    def alltoall(self, input_chunks):
        return self._guard(lambda: self._pg.alltoall(input_chunks),
                           lambda: [_to_host(a) for a in input_chunks])

    def send(self, arrays, dst, tag=0):
        return self._guard(lambda: self._pg.send(arrays, dst, tag), lambda: None)

    def recv(self, src, tag=0):
        return self._guard(lambda: self._pg.recv(src, tag), lambda: None)


class ManagedProcessGroup(ProcessGroup):
    """A process group whose ``allreduce`` runs through a Manager (quorum
    participation, error swallowing), for data-parallel code written
    against a process group. ``size`` and ``rank`` are the quorum's; every
    other collective raises."""

    def __init__(self, manager: Any) -> None:
        super().__init__()
        self._manager = manager

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return self._manager.allreduce(list(arrays), reduce_op=op)

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        # None before the first quorum; the contract is an int
        r = self._manager.replica_rank()
        return 0 if r is None else r

    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        raise RuntimeError("ManagedProcessGroup is configured by its Manager")

    def abort(self) -> None:
        self._manager._pg.abort()

    def shutdown(self) -> None:
        self._manager._pg.shutdown()

    def errored(self) -> Optional[Exception]:
        return self._manager._pg.errored()

    def allgather(self, arrays):
        raise NotImplementedError("managed PG only routes allreduce")

    def broadcast(self, arrays, root=0):
        raise NotImplementedError("managed PG only routes allreduce")

    def alltoall(self, input_chunks):
        raise NotImplementedError("managed PG only routes allreduce")

    def send(self, arrays, dst, tag=0):
        raise NotImplementedError("managed PG only routes allreduce")

    def recv(self, src, tag=0):
        raise NotImplementedError("managed PG only routes allreduce")


class FakeProcessGroupWrapper(ProcessGroup):
    """Test-only fault injection around ``pg``: ``report_future_error``
    fails the futures of upcoming ops, ``report_configure_error`` the next
    ``configure``; every other call goes to ``pg``. Nothing on the main
    path wraps a process group in it."""

    def __init__(self, pg: ProcessGroup) -> None:
        super().__init__()
        self._pg = pg
        self._next_error: Optional[Exception] = None
        self._next_error_skip = 0
        self._next_error_times = 0
        self._next_configure_error: Optional[Exception] = None
        # test hook run at the start of prepare_configure (on the quorum
        # thread): it can stall the prepare past a step boundary
        self._on_prepare: Optional[Callable[[], None]] = None

    @property
    def device_native(self) -> bool:
        # the wrapped group's plane: the Manager reads it off the outermost
        return getattr(self._pg, "device_native", False)

    def set_prepare_hook(self, fn: Optional[Callable[[], None]]) -> None:
        """``fn()`` runs at the start of every ``prepare_configure``."""
        self._on_prepare = fn

    def report_future_error(self, e: Exception, skip_ops: int = 0, times: int = 1) -> None:
        """Fail upcoming ops' futures with ``e``: the next ``skip_ops`` ops
        pass untouched, then ``times`` consecutive ops fail."""
        self._next_error = e
        self._next_error_skip = int(skip_ops)
        self._next_error_times = max(1, int(times))

    def report_configure_error(self, e: Exception) -> None:
        """The next ``configure`` raises ``e``."""
        self._next_configure_error = e

    def set_reroute_observer(self, fn: Optional[Callable[[tuple, int], None]]) -> None:
        setter = getattr(self._pg, "set_reroute_observer", None)
        if setter is not None:
            setter(fn)

    def wire_stats(self) -> Dict[str, float]:
        return self._pg.wire_stats()

    def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        if self._next_configure_error is not None:
            e, self._next_configure_error = self._next_configure_error, None
            raise e
        self._pg.configure(store_addr, replica_rank, replica_world_size, quorum_id=quorum_id)

    def prepare_configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
        if self._on_prepare is not None:
            self._on_prepare()
        if self._next_configure_error is not None:
            e, self._next_configure_error = self._next_configure_error, None
            raise e
        return self._pg.prepare_configure(
            store_addr, replica_rank, replica_world_size, quorum_id=quorum_id
        )

    def abort(self) -> None:
        self._pg.abort()

    def shutdown(self) -> None:
        self._pg.shutdown()

    def errored(self) -> Optional[Exception]:
        return self._pg.errored()

    def size(self) -> int:
        return self._pg.size()

    def rank(self) -> int:
        return self._pg.rank()

    def set_timeout(self, timeout: "float | timedelta") -> None:
        self._pg.set_timeout(timeout)

    def _maybe_fail(self, work: Work) -> Work:
        if self._next_error is None:
            return work
        if self._next_error_skip > 0:
            self._next_error_skip -= 1
            return work
        e = self._next_error
        self._next_error_times -= 1
        if self._next_error_times <= 0:
            self._next_error = None
        fut: Future = Future()

        def _fail(_f: Future) -> None:
            try:
                fut.set_exception(e)
            except RuntimeError:
                pass

        work.get_future().add_done_callback(_fail)
        return FutureWork(fut)

    def allreduce(self, arrays, op=ReduceOp.SUM):
        return self._maybe_fail(self._pg.allreduce(arrays, op))

    def allgather(self, arrays):
        return self._maybe_fail(self._pg.allgather(arrays))

    def broadcast(self, arrays, root=0):
        return self._maybe_fail(self._pg.broadcast(arrays, root))

    def alltoall(self, input_chunks):
        return self._maybe_fail(self._pg.alltoall(input_chunks))

    def send(self, arrays, dst, tag=0):
        return self._maybe_fail(self._pg.send(arrays, dst, tag))

    def recv(self, src, tag=0):
        return self._maybe_fail(self._pg.recv(src, tag))


def _stage_p2p(x: Any) -> Any:
    """A send's host buffer: CUDA tensors are copied into page-locked host
    memory (an ndarray, or a CPU tensor for bf16), the rest as ``_to_host``."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x.detach())
        return out if out.dtype == torch.bfloat16 else out.numpy()
    return _to_host(x)


def _host_alloc(dtype: str, shape: Tuple[int, ...]) -> Any:
    """A fresh host buffer for a received frame: an ndarray, or a CPU
    tensor for bf16."""
    if dtype == "bfloat16":
        return torch.empty(tuple(shape), dtype=torch.bfloat16)
    return np.empty(tuple(shape), np.dtype(dtype))
