"""Checkpoint transport interface and the streaming helpers.

Counterpart of ``torchft_tpu/checkpointing/transport.py``: the
``CheckpointTransport`` ABC the Manager heals through, and the helpers
both transports share:

- ``plan_wire_ranges`` cuts a flattened state into byte-range chunks, so
  one multi-GB leaf still streams as several chunks;
- ``pipelined`` overlaps the wire transfer of chunk i+1 with the finish
  work (placement on the device) of chunk i;
- ``StreamTimings`` / ``ChunkStat`` carry per-chunk throughput back to the
  Manager (its ``heal_chunks`` / ``heal_mb_per_s`` timings);
- ``stream_chunk_bytes`` is the chunk size, ``TORCHFT_STREAM_CHUNK_BYTES``
  (32 MiB by default).
"""

from __future__ import annotations

import queue
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Iterable, List, Optional, Tuple, TypeVar

from torchft_tpu_torch import knobs

T = TypeVar("T")
U = TypeVar("U")

__all__ = [
    "CheckpointTransport",
    "ChunkStat",
    "StreamTimings",
    "pipelined",
    "plan_wire_ranges",
    "stream_chunk_bytes",
]

STREAM_CHUNK_BYTES_ENV = "TORCHFT_STREAM_CHUNK_BYTES"
DEFAULT_STREAM_CHUNK_BYTES = 32 << 20


def stream_chunk_bytes() -> int:
    """The wire-chunk size of streamed heals: ``TORCHFT_STREAM_CHUNK_BYTES``,
    or the default when unset, unparsable or below 1 (a zero chunk would
    never make progress)."""
    try:
        val = int(knobs.env_raw(STREAM_CHUNK_BYTES_ENV, ""))
    except ValueError:
        return DEFAULT_STREAM_CHUNK_BYTES
    return val if val >= 1 else DEFAULT_STREAM_CHUNK_BYTES


def plan_wire_ranges(
    leaf_nbytes: List[int], chunk_bytes: int
) -> List[List[Tuple[int, int, int]]]:
    """Plan wire chunks over flattened leaves as byte ranges.

    Returns a list of chunks, each a list of ``(leaf_idx, offset, nbytes)``
    ranges summing to at most ``chunk_bytes`` (except that every range is
    non-empty, so a chunk always makes progress). Unlike leaf-granularity
    ``split_chunks``, a leaf larger than ``chunk_bytes`` is split across
    chunks — that is what lets a single huge parameter buffer pipeline.
    Deterministic in its inputs, so sender and receiver can independently
    derive the same plan. Zero-byte leaves ride along with the next chunk
    (offset 0, nbytes 0) so every leaf appears in exactly one range."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    chunks: List[List[Tuple[int, int, int]]] = []
    cur: List[Tuple[int, int, int]] = []
    cur_bytes = 0
    for idx, total in enumerate(leaf_nbytes):
        if total == 0:
            cur.append((idx, 0, 0))
            continue
        off = 0
        while off < total:
            take = min(total - off, chunk_bytes - cur_bytes)
            if take == 0:
                chunks.append(cur)
                cur, cur_bytes = [], 0
                continue
            cur.append((idx, off, take))
            off += take
            cur_bytes += take
            if cur_bytes >= chunk_bytes:
                chunks.append(cur)
                cur, cur_bytes = [], 0
    if cur:
        chunks.append(cur)
    if not chunks:
        chunks.append([])
    return chunks


@dataclass
class ChunkStat:
    """Wire timing of one streamed chunk (the transfer, not the finish)."""

    nbytes: int
    transfer_s: float


@dataclass
class StreamTimings:
    """Totals of the last streamed receive, read by the Manager through
    ``CheckpointTransport.last_recv_timings``."""

    total_bytes: int = 0
    total_s: float = 0.0
    chunks: List[ChunkStat] = field(default_factory=list)
    # resilience counters of a multi-source receive
    retries: int = 0  # same-source resumes and re-fetches
    failovers: int = 0  # switches to a fallback source mid-heal
    crc_failures: int = 0  # chunks re-fetched after a crc32 mismatch

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def mb_per_s(self) -> float:
        if self.total_s <= 0:
            return 0.0
        return (self.total_bytes / (1 << 20)) / self.total_s


class _Done:
    __slots__ = ()


_DONE = _Done()


def pipelined(
    items: Iterable[T],
    transfer: Callable[[T], U],
    finish: Callable[[U], None],
    depth: int = 2,
    timings: Optional[StreamTimings] = None,
    size_of: Optional[Callable[[U], int]] = None,
) -> None:
    """Run ``transfer`` over ``items`` on a worker thread while ``finish``
    consumes its results on the calling thread: chunk i+1 is on the wire
    while chunk i is placed. ``depth`` bounds the results transferred but
    not yet finished. A failure on either side stops the stream, and the
    first exception (the transfer's before the finish's) propagates."""
    q: "queue.Queue[Tuple[bool, Any]]" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    t_start = time.perf_counter()

    def producer() -> None:
        try:
            for item in items:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                out = transfer(item)
                dt = time.perf_counter() - t0
                if timings is not None:
                    nb = size_of(out) if size_of is not None else 0
                    timings.chunks.append(ChunkStat(nbytes=nb, transfer_s=dt))
                    timings.total_bytes += nb
                q.put((True, out))
            q.put((True, _DONE))
        except BaseException as e:  # noqa: BLE001 - must unblock the consumer
            q.put((False, e))

    worker = threading.Thread(target=producer, name="torchft_stream", daemon=True)
    worker.start()
    try:
        while True:
            ok, payload = q.get()
            if not ok:
                raise payload
            if payload is _DONE:
                break
            finish(payload)
    except BaseException:
        stop.set()
        # free a slot so a producer blocked in put() sees the stop
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        raise
    finally:
        worker.join(timeout=60)
        if timings is not None:
            timings.total_s = time.perf_counter() - t_start


class CheckpointTransport(ABC):
    """Live-recovery state streaming between replica groups."""

    @abstractmethod
    def metadata(self) -> str:
        """Opaque string other replicas use to reach this transport
        (fetched through the manager's checkpoint_metadata RPC)."""

    def configure(
        self,
        store_addr: str,
        replica_rank: int,
        replica_world_size: int,
        quorum_id: int = 0,
    ) -> None:
        """Per-quorum hook, called after the Manager reconfigures its PG,
        with the same membership under a ``.../recovery/...`` store prefix.
        No-op for address-based transports; ``PGTransport`` rendezvouses its
        recovery process group here."""

    @abstractmethod
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any,
        timeout: "float | timedelta",
    ) -> None:
        """Serve/send ``state_dict`` for ``step`` to the given replica ranks."""

    def disallow_checkpoint(self) -> None:
        """Stop serving (the state is about to be mutated by the optimizer)."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: "float | timedelta"
    ) -> Any:
        """Fetch the state for ``step`` from ``src_rank``."""

    # pull-based transports that can fetch a step from any up-to-date peer
    # set this and implement recv_checkpoint_multi; a push-based transport
    # (PGTransport: only the assigned source sends) keeps it False, so the
    # Manager never waits on a fallback peer that will never send
    supports_multi_source: bool = False

    def recv_checkpoint_multi(
        self,
        sources: List[Tuple[str, Callable[[], str]]],
        step: int,
        timeout: "float | timedelta",
        on_event: Optional[Callable[..., None]] = None,
    ) -> Any:
        """Fetch the state for ``step`` from an ordered list of candidate
        sources, failing over mid-transfer when one dies.

        ``sources`` is ``[(label, metadata_fn), ...]``: ``metadata_fn``
        resolves a peer's transport metadata lazily (the manager's
        checkpoint_metadata RPC), so an unreachable fallback costs nothing
        unless it is tried. ``on_event(kind, **fields)`` receives
        ``heal_retry``, ``heal_failover`` and ``chunk_crc_failure`` as they
        happen."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support multi-source receive"
        )

    def last_recv_timings(self) -> Optional[StreamTimings]:
        """Chunk-stream stats of the most recent ``recv_checkpoint`` (None
        before the first). The Manager records them as ``heal_chunks`` and
        ``heal_mb_per_s``."""
        return getattr(self, "_last_recv_timings", None)

    def shutdown(self, wait: bool = True) -> None:
        """Tear down (terminal)."""
