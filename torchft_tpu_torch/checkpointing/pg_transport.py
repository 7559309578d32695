"""Checkpoint transport over process-group point-to-point sends.

Counterpart of ``torchft_tpu/checkpointing/pg_transport.py:54-490``: a
pickled spec (tree structure and per-leaf metadata) followed by raw
per-leaf frames, sent over a process group of its own (the recovery PG) so
that heal traffic never interleaves with training collectives. Over a PG
that streams raw frames (``ProcessGroupHost``) the wire is RANGED: the
header carries a plan of byte-range chunks (``plan_wire_ranges``) and a
crc32 of each, and the receiver lands chunk i while chunk i+1 is on the
wire. Without raw frames each leaf is one message, windowed.

The receive can be in place, into ``state_dict_template``: a contiguous
host leaf takes its frames straight into its memory; a CUDA leaf takes
them through a page-locked staging buffer, its chunk's crc checked over
those host bytes before one ``copy_`` into the leaf's storage, so every
template tensor keeps its ``data_ptr()`` and the state is never held twice
on the card. Leaves land AS THEY ARRIVE: a failure mid-stream (sender
death, timeout, crc mismatch) raises with the template torn between the
old and the new state, which is safe because the Manager never commits a
failed heal and heals again at the next quorum. A caller outside the
Manager that hands its live state as the template must give the same
guarantee or pass a scratch template.
"""

from __future__ import annotations

import logging
import pickle
import zlib
from datetime import timedelta
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpointing._serialization import (
    TensorMeta,
    TreeSpecPayload,
    can_absorb,
    flatten_state,
    leaf_from_bytes,
    place_leaf_like,
    template_leaves_for,
    tree_from_leaves,
)
from torchft_tpu_torch.checkpointing.transport import (
    CheckpointTransport,
    StreamTimings,
    pipelined,
    plan_wire_ranges,
    stream_chunk_bytes,
)
from torchft_tpu_torch.ops.quantization import host_empty
from torchft_tpu_torch.process_group import ProcessGroup

logger = logging.getLogger(__name__)

__all__ = ["PGTransport"]


def _to_seconds(timeout: "float | timedelta") -> float:
    return timeout.total_seconds() if isinstance(timeout, timedelta) else float(timeout)


def _chunk_crc(wires: List[np.ndarray], chunk: List[Tuple[int, int, int]]) -> int:
    """crc32 over a chunk's concatenated range payloads, in plan order."""
    crc = 0
    for j, off, ln in chunk:
        crc = zlib.crc32(wires[j][off:off + ln], crc)
    return crc & 0xFFFFFFFF


def _flat_bytes(x: Any) -> np.ndarray:
    """A staged payload or a received message entry (an ndarray, a CPU
    tensor, or bytes) as flat uint8."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy()
    if isinstance(x, np.ndarray):
        return x.reshape(-1).view(np.uint8)
    return np.frombuffer(x, np.uint8)


class PGTransport(CheckpointTransport):
    """Send checkpoints over a process group's ``send`` / ``recv``.

    ``state_dict_template`` (a zero-arg callable returning a pytree of the
    sent state's structure, such as ``Manager.state_dict_template``) makes
    the receive land in place (see the module docstring); without one,
    leaves land in fresh CPU tensors. ``snapshot_send=False`` streams CPU
    leaves straight from the caller's tensors instead of a copy: safe only
    when nothing mutates them during ``send_checkpoint``. The process group
    is the caller's: ``shutdown`` leaves it alone."""

    SEND_WINDOW = 4
    # cap of one batched message (the legacy wire): consecutive leaves up to
    # this many bytes, derived alike by both sides from the spec
    BATCH_GROUP_BYTES = 256 << 20

    def __init__(
        self,
        pg: ProcessGroup,
        timeout: "float | timedelta" = 60.0,
        state_dict_template: Optional[Callable[[], Any]] = None,
        snapshot_send: bool = True,
    ) -> None:
        if state_dict_template is not None and not callable(state_dict_template):
            raise TypeError(
                "state_dict_template must be a zero-arg callable returning the "
                f"template pytree, not the pytree itself (got "
                f"{type(state_dict_template).__name__})"
            )
        self._pg = pg
        self._timeout = _to_seconds(timeout)
        self._template_fn = state_dict_template
        self._snapshot_send = snapshot_send

    def metadata(self) -> str:
        return "<pg_transport>"

    def configure(
        self,
        store_addr: str,
        replica_rank: int,
        replica_world_size: int,
        quorum_id: int = 0,
    ) -> None:
        """Rendezvous the recovery PG with the current quorum. It must be
        another instance than the Manager's PG: one generation carries
        either p2p or collective traffic."""
        self._pg.configure(store_addr, replica_rank, replica_world_size, quorum_id=quorum_id)

    @classmethod
    def _wire_groups(cls, spec: TreeSpecPayload) -> List[List[int]]:
        """Leaf indices of each batched message: consecutive leaves up to
        ``BATCH_GROUP_BYTES`` (at least one leaf each)."""
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_bytes = 0
        for i, meta in enumerate(spec.leaves):
            if cur and cur_bytes + meta.nbytes > cls.BATCH_GROUP_BYTES:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += meta.nbytes
        if cur:
            groups.append(cur)
        return groups

    # -- send ---------------------------------------------------------------
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any,
        timeout: "float | timedelta",
    ) -> None:
        spec, payloads = flatten_state(state_dict, snapshot=self._snapshot_send)
        wires = [_flat_bytes(p) for p in payloads]
        ranged = getattr(self._pg, "streams_raw_frames", False)
        ranges: List[List[Tuple[int, int, int]]] = []
        if ranged:
            chunk_bytes = min(self.BATCH_GROUP_BYTES, stream_chunk_bytes())
            ranges = plan_wire_ranges([m.nbytes for m in spec.leaves], chunk_bytes)
            crcs = [_chunk_crc(wires, chunk) for chunk in ranges]
            header = pickle.dumps((step, spec, "ranged", ranges, crcs))
        else:
            header = pickle.dumps((step, spec))
        for dst in dst_ranks:
            self._pg.send([np.frombuffer(header, np.uint8)], dst, tag=1).wait(self._timeout)
            # at most SEND_WINDOW messages in flight: backpressure on a peer
            # that buffers what it has not read yet
            messages = (
                [[wires[j][off:off + ln] for j, off, ln in chunk] for chunk in ranges]
                if ranged else [[w] for w in wires]
            )
            pending: List[Any] = []
            for bufs in messages:
                pending.append(self._pg.send(bufs, dst, tag=2))
                if len(pending) >= self.SEND_WINDOW:
                    pending.pop(0).wait(self._timeout)
            for work in pending:
                work.wait(self._timeout)

    # -- receive ------------------------------------------------------------
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: "float | timedelta"
    ) -> Any:
        timeout_s = _to_seconds(timeout)
        header = self._pg.recv(src_rank, tag=1).get_future().wait(timeout_s)
        if not header:
            raise RuntimeError(f"no checkpoint header from rank {src_rank} "
                               f"(pg errored: {self._pg.errored()})")
        # (step, spec) per leaf; (step, spec, True) batched; (step, spec,
        # "ranged", ranges[, crcs]) ranged
        got_step, spec, *rest = pickle.loads(_flat_bytes(header[0]).tobytes())
        if got_step != step:
            raise RuntimeError(f"expected checkpoint step {step}, got {got_step}")
        template_leaves: Optional[List[Any]] = None
        if self._template_fn is not None:
            template_leaves = template_leaves_for(spec, self._template_fn(), logger)
        proto = rest[0] if rest else False
        if proto == "ranged":
            return self._recv_ranged(
                src_rank, spec, rest[1], template_leaves, timeout_s,
                crcs=rest[2] if len(rest) > 2 else None,
            )

        def target_of(i: int, meta: TensorMeta) -> Optional[Any]:
            if template_leaves is not None and meta.kind == "array" and can_absorb(
                template_leaves[i], meta.shape, meta.dtype, require_contiguous=True
            ):
                return template_leaves[i]
            return None

        def finish_leaf(i: int, meta: TensorMeta, buf: Any) -> Any:
            leaf = leaf_from_bytes(meta, buf)
            if template_leaves is not None and meta.kind == "array":
                leaf = place_leaf_like(leaf, template_leaves[i], logger)
            return leaf

        groups = self._wire_groups(spec) if proto else [[i] for i in range(len(spec.leaves))]
        targets = [target_of(i, m) for i, m in enumerate(spec.leaves)]
        views = [_byte_view(t) if t is not None else None for t in targets]
        leaves: List[Any] = []
        for group in groups:
            gviews = [views[i] for i in group]
            got = self._pg.recv_into(gviews, src_rank, tag=2).get_future().wait(timeout_s)
            if not got or len(got) != len(group):
                raise RuntimeError(
                    f"recv from rank {src_rank} returned {len(got) if got else 0} of "
                    f"{len(group)} leaves (pg errored: {self._pg.errored()})"
                )
            for k, i in enumerate(group):
                if views[i] is not None and got[k] is views[i]:
                    leaves.append(targets[i])
                else:
                    leaves.append(finish_leaf(i, spec.leaves[i], got[k]))
        return tree_from_leaves(spec, leaves)

    def _recv_ranged(
        self,
        src_rank: int,
        spec: TreeSpecPayload,
        ranges: List[List[Tuple[int, int, int]]],
        template_leaves: Optional[List[Any]],
        timeout_s: float,
        crcs: Optional[List[int]] = None,
    ) -> Any:
        """Receive the ranged wire, one message per chunk of byte ranges.
        The receive of chunk i+1 runs on a worker thread while this thread
        lands chunk i: the H2D copies of CUDA leaves, and the finishing of
        leaves whose last range arrived. A chunk whose crc32 (over the
        received host bytes) disagrees with the header's raises before any
        of its bytes reach a CUDA leaf or a finished leaf."""
        n = len(spec.leaves)
        # per leaf: a flat uint8 host destination (a host template leaf's
        # own memory, or a wire buffer), or a CUDA template leaf's bytes
        dests: List[Any] = []
        on_card = [False] * n
        absorbed = [False] * n
        for i, meta in enumerate(spec.leaves):
            t = template_leaves[i] if template_leaves is not None else None
            if meta.kind == "array" and can_absorb(t, meta.shape, meta.dtype,
                                                   require_contiguous=True):
                absorbed[i] = True
                on_card[i] = isinstance(t, torch.Tensor) and t.is_cuda
                dests.append(_byte_view(t))
            else:
                dests.append(np.empty(meta.nbytes, np.uint8))
        leaves: List[Any] = [None] * n
        # a leaf may be None itself (torch pytrees keep None leaves)
        finished = [False] * n
        remaining = [m.nbytes for m in spec.leaves]

        def finalize(i: int) -> None:
            meta = spec.leaves[i]
            finished[i] = True
            if absorbed[i]:
                leaves[i] = template_leaves[i]
                return
            leaf = leaf_from_bytes(meta, dests[i])
            if template_leaves is not None and meta.kind == "array":
                leaf = place_leaf_like(leaf, template_leaves[i], logger)
            leaves[i] = leaf

        def transfer(item: Tuple[int, List[Tuple[int, int, int]]]) -> Any:
            ci, chunk = item
            card_bytes = sum(ln for j, _off, ln in chunk if on_card[j])
            staging = host_empty((card_bytes,), torch.uint8, pinned=True) if card_bytes else None
            gviews: List[np.ndarray] = []
            at = 0
            for j, off, ln in chunk:
                if on_card[j]:
                    gviews.append(staging[at:at + ln])
                    at += ln
                else:
                    gviews.append(dests[j][off:off + ln])
            got = self._pg.recv_into(gviews, src_rank, tag=2).get_future().wait(timeout_s)
            if not got or len(got) != len(chunk):
                raise RuntimeError(
                    f"ranged recv from rank {src_rank} returned {len(got) if got else 0} "
                    f"of {len(chunk)} ranges (pg errored: {self._pg.errored()})"
                )
            for k, (_j, _off, ln) in enumerate(chunk):
                if got[k] is gviews[k]:
                    continue  # landed straight in its destination
                buf = _flat_bytes(got[k])
                if buf.size != ln:
                    raise RuntimeError(
                        f"ranged recv: range {k} carries {buf.size} bytes, plan says {ln}"
                    )
                np.copyto(gviews[k], buf)
            if crcs is not None:
                crc = 0
                for gv in gviews:
                    crc = zlib.crc32(gv, crc)
                if crc & 0xFFFFFFFF != crcs[ci] & 0xFFFFFFFF:
                    raise RuntimeError(
                        f"ranged recv: chunk {ci} crc32 mismatch (got "
                        f"{crc & 0xFFFFFFFF:#010x}, header says "
                        f"{crcs[ci] & 0xFFFFFFFF:#010x}); discarding heal"
                    )
            return chunk, gviews

        def finish(received: Any) -> None:
            chunk, gviews = received
            for (j, off, ln), gv in zip(chunk, gviews):
                if on_card[j]:
                    dests[j][off:off + ln].copy_(torch.from_numpy(gv))
                remaining[j] -= ln
                if remaining[j] < 0:
                    raise RuntimeError(f"leaf {j}: overlapping or duplicate wire ranges")
                if remaining[j] == 0 and not finished[j]:
                    finalize(j)

        timings = StreamTimings()
        pipelined(
            list(enumerate(ranges)), transfer, finish, depth=2, timings=timings,
            size_of=lambda r: sum(ln for _j, _off, ln in r[0]),
        )
        self._last_recv_timings = timings
        missing = [i for i in range(n) if not finished[i]]
        if missing:
            raise RuntimeError(f"ranged checkpoint missing leaves {missing}")
        return tree_from_leaves(spec, leaves)

    def shutdown(self, wait: bool = True) -> None:
        pass  # the process group is the caller's


def _byte_view(t: Any) -> Any:
    """A contiguous host leaf's memory as flat uint8 (an ndarray sharing
    it), or a CUDA leaf's bytes as a flat uint8 tensor. A tensor is viewed
    through ``.data``, whose version counter is its own: a live parameter
    written by a heal does not fail a backward the healing replica has in
    flight (its gradients are discarded: it sits the step out)."""
    if isinstance(t, torch.Tensor):
        if t.numel() == 0:  # an empty flat view has stride 0, which .view refuses
            return torch.empty(0, dtype=torch.uint8, device=t.device) if t.is_cuda \
                else np.zeros(0, np.uint8)
        flat = t.data.reshape(-1).view(torch.uint8)
        return flat if flat.is_cuda else flat.numpy()
    return t.reshape(-1).view(np.uint8)
