"""Checkpoint transport interface and the wire-range planner.

Counterpart of ``torchft_tpu/checkpointing/transport.py``: the
``CheckpointTransport`` ABC the Manager heals through, and
``plan_wire_ranges``, which cuts a flattened state into byte-range chunks
so one multi-GB leaf still streams as several chunks.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from datetime import timedelta
from typing import Any, List, Tuple

__all__ = ["CheckpointTransport", "plan_wire_ranges"]


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
        """Per-quorum hook, called after the Manager reconfigures its PG.
        No-op for address-based transports."""

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

    def shutdown(self, wait: bool = True) -> None:
        """Tear down (terminal)."""
