"""HTTP checkpoint transport: the Manager's default live-recovery path.

Counterpart of ``torchft_tpu/checkpointing/http_transport.py``: a threaded
HTTP server serves ``/checkpoint/{step}/metadata`` and
``/checkpoint/{step}/chunk_{i}``, gated by an RWLock so serving stops while
the optimizer mutates state; a receiver fetches the chunks in parallel.

A chunk body is a run of frames, each a 24-byte ``[leaf_idx, offset,
nbytes]`` header and the raw byte range, written straight from the staged
host copy and read straight into the receiver's per-leaf buffer. Chunks are
byte ranges (``plan_wire_ranges``), so a multi-GB leaf splits across
parallel fetches; for equal staged states the bodies are the reference's,
byte for byte.

Wire version 3 (the metadata carries ``(spec, num_chunks, 3)``): a ``crc=1``
query appends a 4-byte crc32 trailer over the canonical chunk body, and
``offset=N`` serves the body from byte ``N``. The receiver keeps a running
crc across reconnects, so a stalled fetch resumes at its last received
byte and a corrupt chunk is caught and fetched again instead of loaded.
Byte credits of a chunk are applied only once it verified, so no leaf is
finished from unverified bytes. A v1 sender (whole-leaf ``[leaf_idx,
nbytes]`` frames) and a v2 one (no crc, no resume: a failed chunk starts
over) are still understood on receive.

``recv_checkpoint_multi`` fails over across an ordered list of sources
under one deadline: every max-step peer stages the same state and the plan
is deterministic, so a chunk half-fetched from a dying source resumes at
the same byte offset on the next. Same-source retries run under the
transport's ``RetryPolicy``; ``on_event`` hears ``heal_retry``,
``heal_failover`` and ``chunk_crc_failure``.

With ``state_dict_template`` the receive lands in place: a contiguous CPU
tensor (or writable ndarray) leaf of the template takes the socket's bytes
in its own memory, and a CUDA one is written by one copy into its storage
once its bytes are in (``place_leaf_like``), so the template's tensors keep
their ``data_ptr()``. A failed receive leaves such a template torn, which
only the Manager's discard-and-retry heal protocol makes safe.
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import threading
import time
import urllib.parse
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing._serialization import (
    TreeSpecPayload,
    alloc_leaf,
    can_absorb,
    flatten_state,
    leaf_from_bytes,
    payload_memoryview,
    place_leaf_like,
    template_leaves_for,
    tree_from_leaves,
)
from torchft_tpu_torch.checkpointing.transport import (
    CheckpointTransport,
    ChunkStat,
    StreamTimings,
    plan_wire_ranges,
    stream_chunk_bytes,
)
from torchft_tpu_torch.retry import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["HTTPTransport"]

_FRAME = struct.Struct("<qq")  # v1: leaf_idx, nbytes (a whole leaf)
_FRAME_V2 = struct.Struct("<qqq")  # leaf_idx, offset, nbytes (a byte range)
_CRC = struct.Struct("<I")  # v3 chunk trailer: crc32 of the canonical body
_WIRE_VERSION = 3
# cap on auto-planned chunks (num_chunks=0): bounds fetch parallelism
_AUTO_MAX_CHUNKS = 8


def _to_seconds(timeout: "float | timedelta") -> float:
    return timeout.total_seconds() if isinstance(timeout, timedelta) else float(timeout)


class HTTPTransport(CheckpointTransport):
    """Serve checkpoints over HTTP; receive with parallel chunk fetches.

    ``num_chunks=0`` plans byte-range chunks of about
    ``TORCHFT_STREAM_CHUNK_BYTES`` (32 MiB by default, at most 8 chunks);
    ``num_chunks > 0`` forces that many. ``client_only`` binds no listener
    (a pure receiver). ``retry_policy`` bounds the same-source retries of a
    chunk (``RetryPolicy.from_env()`` by default).
    ``state_dict_template`` (a zero-arg callable returning a pytree of the
    served state's structure, such as ``Manager.state_dict_template``)
    makes the receive land in place."""

    supports_multi_source = True

    def __init__(
        self,
        timeout: "float | timedelta" = 60.0,
        num_chunks: int = 0,
        hostname: str = "",
        state_dict_template: Optional[Callable[[], Any]] = None,
        retry_policy: Optional[RetryPolicy] = None,
        client_only: bool = False,
    ) -> None:
        if state_dict_template is not None and not callable(state_dict_template):
            raise TypeError(
                "state_dict_template must be a zero-arg callable returning the "
                "template pytree, not the pytree itself "
                f"(got {type(state_dict_template).__name__})"
            )
        self._timeout = _to_seconds(timeout)
        self._num_chunks = num_chunks
        self._hostname = hostname
        self._template_fn = state_dict_template
        self._retry_policy = retry_policy if retry_policy is not None else RetryPolicy.from_env()
        # test-only serve-side faults (inject_chunk_fault)
        self._fault_lock = threading.Lock()
        self._chunk_faults: List[Dict[str, Any]] = []
        # write-locked whenever there is NO servable checkpoint; in-flight
        # HTTP requests hold the read side
        self._state_lock = RWLock(timeout=self._timeout)
        self._state_lock.w_acquire()
        self._have_state = False
        # (step, spec, payloads, assignments), swapped atomically: a handler
        # captures it once, so a restage never tears a body in flight
        self._staged: Optional[tuple] = None
        # served-vs-expected chunk fetches of the staged step: the serving
        # window stays open (bounded) until expected receivers fetched
        self._fetch_cond = threading.Condition()
        self._expected_fetches = 0
        self._served_fetches = 0

        transport = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("http_transport: " + fmt, *args)

            def do_GET(self) -> None:
                try:
                    self._get()
                except Exception as e:  # noqa: BLE001 - a bad request, not a dead server
                    logger.exception("http_transport handler failed")
                    try:
                        self.send_error(500, str(e))
                    except OSError:
                        pass

            def _get(self) -> None:
                # a stalled receiver times out instead of holding the read
                # lock (and disallow_checkpoint) forever
                self.connection.settimeout(transport._timeout)
                raw_path, _, raw_query = self.path.partition("?")
                parts = raw_path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "checkpoint" or not parts[1].isdigit():
                    self.send_error(404, "unknown path")
                    return
                step, what = int(parts[1]), parts[2]
                query = urllib.parse.parse_qs(raw_query)
                if not transport._state_lock.r_acquire(timeout=transport._timeout):
                    self.send_error(503, "checkpoint not available (locked)")
                    return
                try:
                    staged = transport._staged
                    if staged is None or staged[0] != step:
                        have = staged[0] if staged else None
                        self.send_error(400, f"serving step {have}, asked {step}")
                        return
                    if not transport._stream_response(self, staged, what, query):
                        self.send_error(404, f"unknown resource {what}")
                except (BrokenPipeError, ConnectionError, TimeoutError, OSError):
                    # receiver gone mid-stream: drop the connection, never
                    # write an error page into a partial body
                    self.close_connection = True
                finally:
                    transport._state_lock.r_release()

        self._server: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        if not client_only:
            self._server = ThreadingHTTPServer(("0.0.0.0", 0), _Handler)
            self._server.daemon_threads = True
            self._serve_thread = threading.Thread(
                target=self._server.serve_forever, daemon=True, name="torchft_http_ckpt"
            )
            self._serve_thread.start()

    # -- serving ------------------------------------------------------------
    def inject_chunk_fault(self, chunk: int, mode: str, times: int = 1) -> None:
        """Test-only: the next ``times`` serves of ``chunk`` fail.

        ``"corrupt"`` flips one payload byte of the body while the crc32
        trailer stays canonical; ``"die"`` drops the connection about
        halfway through the requested span (a source dying mid-heal).
        ``times=-1`` faults every serve (a dead source: failover is the
        only way through)."""
        if mode not in ("corrupt", "die"):
            raise ValueError(f"unknown fault mode {mode!r}")
        with self._fault_lock:
            self._chunk_faults.append({"chunk": chunk, "mode": mode, "times": times})

    def _take_fault(self, chunk: int) -> Optional[str]:
        with self._fault_lock:
            for f in self._chunk_faults:
                if f["chunk"] == chunk and f["times"] != 0:
                    if f["times"] > 0:
                        f["times"] -= 1
                    return f["mode"]
        return None

    def _stream_response(
        self, handler: BaseHTTPRequestHandler, staged: tuple, what: str, query: dict
    ) -> bool:
        """Write ``what`` from the captured snapshot (False: no such
        resource). A chunk body streams from the staged payloads, from byte
        ``offset`` of the canonical body, with a crc32 trailer over the
        whole canonical body when ``crc=1``."""
        step, spec, payloads, assignments = staged
        if what == "metadata":
            body = pickle.dumps((spec, len(assignments), _WIRE_VERSION))
            handler.send_response(200)
            handler.send_header("Content-Type", "application/octet-stream")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
            return True
        if not what.startswith("chunk_") or not what[len("chunk_"):].isdigit():
            return False
        i = int(what[len("chunk_"):])
        if not 0 <= i < len(assignments):
            return False
        want_crc = query.get("crc", ["0"])[0] == "1"
        start = int(query.get("offset", ["0"])[0])
        ranges = assignments[i]
        body_len = sum(_FRAME_V2.size + n for _j, _off, n in ranges)
        if not 0 <= start <= body_len:
            return False
        fault = self._take_fault(i)
        die_after = max((body_len - start) // 2, 1) if fault == "die" else None
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header(
            "Content-Length", str(body_len - start + (_CRC.size if want_crc else 0))
        )
        handler.end_headers()
        crc = 0
        pos = 0  # cursor in the canonical body
        written = 0
        corrupt_pending = fault == "corrupt"
        for j, off, n in ranges:
            mv = payload_memoryview(payloads[j])
            for is_payload, seg in ((False, _FRAME_V2.pack(j, off, n)), (True, mv[off:off + n])):
                if want_crc:
                    crc = zlib.crc32(seg, crc)
                if pos + len(seg) > start:
                    out = seg[max(0, start - pos):]
                    if corrupt_pending and is_payload and len(out):
                        out = bytearray(out)
                        out[0] ^= 0xFF
                        corrupt_pending = False
                    if die_after is not None and written + len(out) >= die_after:
                        handler.wfile.write(out[:max(die_after - written, 0)])
                        handler.close_connection = True
                        return True
                    handler.wfile.write(out)
                    written += len(out)
                pos += len(seg)
        if want_crc:
            handler.wfile.write(_CRC.pack(crc & 0xFFFFFFFF))
        with self._fetch_cond:
            # a serve of an older staging does not count toward this one's
            current = self._staged
            if current is not None and current[0] == step:
                self._served_fetches += 1
                self._fetch_cond.notify_all()
        return True

    def metadata(self) -> str:
        if self._server is None:
            raise RuntimeError("client_only transport has no serve address (metadata())")
        host = self._hostname or socket.gethostname()
        return f"http://{host}:{self._server.server_address[1]}"

    def staged_step(self) -> Optional[int]:
        """The step staged for serving, or None when the window is closed."""
        staged = self._staged
        return staged[0] if staged is not None else None

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any,
        timeout: "float | timedelta", snapshot: bool = True,
    ) -> None:
        """Stage a host copy of the state and open the serving window
        (pull-based: "send" makes it available until disallow_checkpoint).
        ``dst_ranks`` empty stages a standby snapshot nobody is expected
        to fetch. ``snapshot=False`` stages contiguous CPU tensors without
        a copy: the caller hands them over and never writes them again."""
        if self._server is None:
            raise RuntimeError("client_only transport cannot stage checkpoints")
        spec, payloads = flatten_state(state_dict, snapshot=snapshot)
        nbytes = [m.nbytes for m in spec.leaves]
        total = sum(nbytes)
        if self._num_chunks > 0:
            chunk_bytes = max(1, -(-total // self._num_chunks))
        else:
            chunk_bytes = stream_chunk_bytes()
            if total > chunk_bytes * _AUTO_MAX_CHUNKS:
                chunk_bytes = -(-total // _AUTO_MAX_CHUNKS)
        assignments = plan_wire_ranges(nbytes, chunk_bytes)
        self._staged = (step, spec, payloads, assignments)
        with self._fetch_cond:
            self._expected_fetches = len(assignments) * len(dst_ranks)
            self._served_fetches = 0
        if not self._have_state:
            self._have_state = True
            self._state_lock.w_release()

    def disallow_checkpoint(self, grace: Optional[float] = None) -> None:
        """Close the serving window, after a grace (default: the timeout,
        at most 10 s) for the expected fetches to be served."""
        if not self._have_state:
            return
        grace = min(self._timeout, 10.0) if grace is None else grace
        with self._fetch_cond:
            self._fetch_cond.wait_for(
                lambda: self._served_fetches >= self._expected_fetches, timeout=grace
            )
        if not self._state_lock.w_acquire(timeout=self._timeout):
            # a straggler still streaming keeps its snapshot; close the
            # window to new requests and re-lock at the next disallow
            logger.warning("slow checkpoint receiver still streaming; closing the "
                           "serving window without re-locking")
            self._staged = None
            return
        self._have_state = False
        self._staged = None

    # -- receiving ----------------------------------------------------------
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: "float | timedelta"
    ) -> Any:
        return self.recv_checkpoint_multi(
            [(f"replica_rank_{src_rank}", lambda: metadata)], step, timeout
        )

    def recv_checkpoint_multi(
        self,
        sources: List[Tuple[str, Callable[[], str]]],
        step: int,
        timeout: "float | timedelta",
        on_event: Optional[Callable[..., None]] = None,
    ) -> Any:
        """Fetch ``step`` from the first source that can finish it, under
        one deadline. Chunk progress (byte offset, running crc, deferred
        credits) carries over to the next source when its plan (chunk count
        and leaf sizes) is the same; otherwise the receive starts over."""
        timeout_s = _to_seconds(timeout)
        deadline = time.monotonic() + timeout_s
        emit = on_event if on_event is not None else (lambda kind, **f: None)
        timings = StreamTimings()
        t_all = time.perf_counter()
        rs: Optional[_RecvState] = None
        last_exc: Optional[BaseException] = None
        tried = 0
        for src_i, (label, metadata_fn) in enumerate(sources):
            if time.monotonic() >= deadline:
                break
            if src_i > 0:
                timings.failovers += 1
                emit("heal_failover", source=label, prior_error=repr(last_exc))
            tried += 1
            try:
                base = f"{metadata_fn()}/checkpoint/{step}"
                meta_timeout = min(timeout_s, max(deadline - time.monotonic(), 0.001))
                with urllib.request.urlopen(f"{base}/metadata", timeout=meta_timeout) as r:
                    raw_meta = r.read()
            except Exception as e:  # noqa: BLE001 - any peer error: the next peer
                last_exc = e
                continue
            # v1 senders ship (spec, num_chunks); v2 and on append the version
            spec, num_chunks, *rest = pickle.loads(raw_meta)
            if not isinstance(spec, TreeSpecPayload):
                last_exc = ConnectionError(f"{label}: bad checkpoint metadata")
                continue
            version = rest[0] if rest else 1
            sig = (num_chunks, tuple(m.nbytes for m in spec.leaves))
            if rs is None or rs.sig != sig:
                if rs is not None:
                    logger.warning("heal source %s plans %s, prior source planned %s; "
                                   "restarting the receive from scratch", label, sig, rs.sig)
                rs = _RecvState(spec, num_chunks, self._template_fn)
            try:
                self._fetch_all(rs, base, version, deadline, timeout_s, timings, emit, label)
            except Exception as e:  # noqa: BLE001 - exhausted on this peer
                last_exc = e
                continue
            # zero-byte leaves have no bytes on the wire
            for i, rem in enumerate(rs.remaining):
                if rem == 0 and not rs.finished[i]:
                    rs.buffer_for(i)
                    rs.finish_leaf(i)
            missing = [i for i, done in enumerate(rs.finished) if not done]
            if missing:
                raise RuntimeError(f"checkpoint chunks missing leaves {missing}")
            timings.total_s = time.perf_counter() - t_all
            self._last_recv_timings = timings
            return tree_from_leaves(rs.spec, rs.leaves)
        timings.total_s = time.perf_counter() - t_all
        self._last_recv_timings = timings
        raise RuntimeError(
            f"heal failed: all {tried}/{len(sources)} source(s) exhausted within "
            f"{timeout_s:.1f}s (last error: {last_exc!r})"
        ) from last_exc

    def _fetch_all(
        self,
        rs: "_RecvState",
        base: str,
        version: int,
        deadline: float,
        timeout_s: float,
        timings: StreamTimings,
        emit: Callable[..., None],
        label: str,
    ) -> None:
        """Fetch every unfinished chunk from one source in parallel, each
        with a same-source retry loop: a stall resumes at its offset when
        the source speaks v3, a crc mismatch fetches the chunk again from
        byte 0."""
        todo = [st for st in rs.chunk_states if not st.done]
        if not todo:
            return
        policy = self._retry_policy

        def run(st: _ChunkFetch) -> None:
            attempts = 0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"heal deadline exhausted before chunk {st.i}")
                try:
                    self._fetch_chunk_once(rs, st, base, version,
                                           min(timeout_s, remaining), timings)
                    return
                except _ChunkCrcError as e:
                    # corrupt bytes are never credited: start the chunk over
                    st.reset()
                    with rs.stats_lock:
                        timings.crc_failures += 1
                    emit("chunk_crc_failure", chunk=st.i, source=label)
                    err: Exception = e
                except (ConnectionError, TimeoutError, OSError) as e:
                    if version < 3:
                        st.reset()  # a v2 source cannot serve a body suffix
                    err = e
                attempts += 1
                if attempts >= policy.max_attempts:
                    raise err
                with rs.stats_lock:
                    timings.retries += 1
                emit("heal_retry", chunk=st.i, source=label, attempt=attempts,
                     resume_offset=st.body_off, error=repr(err))
                pause = policy.backoff_s(attempts + 1)
                time.sleep(min(pause, max(deadline - time.monotonic(), 0)))

        with ThreadPoolExecutor(max_workers=max(1, min(len(todo), 8))) as ex:
            futs = [ex.submit(run, st) for st in todo]
            errs = [f.exception() for f in futs]
        for e in errs:
            if e is not None:
                raise e

    def _fetch_chunk_once(
        self,
        rs: "_RecvState",
        st: "_ChunkFetch",
        base: str,
        version: int,
        timeout_s: float,
        timings: StreamTimings,
    ) -> None:
        """One attempt at chunk ``st.i``: read its frames into the leaves'
        receive buffers, from ``st.body_off`` when the source speaks v3.
        The chunk's byte credits wait in ``st.pending`` until it verified
        (v3: the crc trailer; v1/v2: a clean end), so a corrupt chunk is
        fetched again with idempotent rewrites and no leaf is finished from
        unverified bytes."""
        frame = _FRAME_V2 if version >= 2 else _FRAME
        want_crc = version >= 3
        url = f"{base}/chunk_{st.i}"
        if want_crc:
            url += "?crc=1" + (f"&offset={st.body_off}" if st.body_off else "")
        t0 = time.perf_counter()
        attempt_bytes = 0
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            while True:
                if st.cur is None:
                    hdr = _read_upto(r, frame.size)
                    if not hdr:
                        if want_crc:
                            raise ConnectionError(
                                f"chunk {st.i}: stream ended before its crc trailer")
                        break  # v1/v2: the chunk's clean end
                    if want_crc and len(hdr) == _CRC.size:
                        expected = _CRC.unpack(hdr)[0]
                        if st.crc & 0xFFFFFFFF != expected:
                            raise _ChunkCrcError(
                                f"chunk {st.i}: crc32 mismatch (got {st.crc & 0xFFFFFFFF:#010x}, "
                                f"trailer {expected:#010x})")
                        break  # verified
                    if len(hdr) < frame.size:
                        # a partial header is not counted in body_off: a
                        # resume reads the whole header again
                        raise ConnectionError(f"chunk {st.i}: truncated frame header")
                    if version >= 2:
                        leaf_idx, off, nbytes = frame.unpack(hdr)
                    else:
                        leaf_idx, nbytes = frame.unpack(hdr)
                        off = 0
                    if not 0 <= leaf_idx < len(rs.spec.leaves):
                        raise ConnectionError(
                            f"chunk {st.i}: frame names leaf {leaf_idx} of {len(rs.spec.leaves)}")
                    meta = rs.spec.leaves[leaf_idx]
                    if version < 2 and nbytes != meta.nbytes:
                        raise ConnectionError(
                            f"chunk {st.i} leaf {leaf_idx}: frame carries {nbytes} bytes but "
                            f"the leaf spec says {meta.nbytes}")
                    if off < 0 or nbytes < 0 or off + nbytes > meta.nbytes:
                        raise ConnectionError(
                            f"chunk {st.i} leaf {leaf_idx}: range [{off}, {off + nbytes}) "
                            f"outside the leaf's {meta.nbytes} bytes")
                    if want_crc:
                        st.crc = zlib.crc32(hdr, st.crc)
                    st.body_off += frame.size
                    st.cur = (leaf_idx, off, nbytes, 0)
                leaf_idx, off, nbytes, got = st.cur
                span = memoryview(rs.buffer_for(leaf_idx))[off:off + nbytes]
                while got < nbytes:
                    n = r.readinto(span[got:])
                    if not n:
                        raise ConnectionError(
                            f"chunk {st.i} truncated at leaf {leaf_idx} "
                            f"({got}/{nbytes} bytes of range)")
                    if want_crc:
                        st.crc = zlib.crc32(span[got:got + n], st.crc)
                    st.body_off += n
                    got += n
                    st.cur = (leaf_idx, off, nbytes, got)
                    attempt_bytes += n
                st.pending.append((leaf_idx, nbytes))
                st.cur = None
        for leaf_idx, n in st.pending:
            if rs.mark_written(leaf_idx, n):
                rs.finish_leaf(leaf_idx)
        st.pending = []
        st.done = True
        with rs.stats_lock:
            timings.chunks.append(ChunkStat(attempt_bytes, time.perf_counter() - t0))
            timings.total_bytes += attempt_bytes

    def shutdown(self, wait: bool = True) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if wait and self._serve_thread is not None:
            self._serve_thread.join(timeout=5)


class _ChunkCrcError(ConnectionError):
    """The chunk's crc32 trailer disagrees with the received body."""


def _read_upto(r: Any, n: int) -> bytes:
    """Up to ``n`` bytes, short only at the end of the stream."""
    buf = b""
    while len(buf) < n:
        got = r.read(n - len(buf))
        if not got:
            break
        buf += got
    return buf


class _ChunkFetch:
    """Resumable fetch state of one chunk, kept across reconnects and
    failovers: ``body_off`` is the canonical-body byte to resume from,
    ``crc`` the running crc32 of what was consumed, ``cur`` a range read in
    part ``(leaf_idx, off, nbytes, got)``, ``pending`` the byte credits
    waiting for the chunk to verify."""

    __slots__ = ("i", "body_off", "crc", "cur", "pending", "done")

    def __init__(self, i: int) -> None:
        self.i = i
        self.reset()

    def reset(self) -> None:
        self.body_off = 0
        self.crc = 0
        self.cur: Optional[Tuple[int, int, int, int]] = None
        self.pending: List[Tuple[int, int]] = []
        self.done = False


class _RecvState:
    """Reassembly state of one multi-source receive: the receive buffers,
    each leaf's bytes still to come, and the chunks' fetch states. A leaf's
    ranges may arrive on different fetch threads; the thread whose chunk
    credits its last bytes finishes it (places it on its template), while
    other chunks are still on the wire."""

    def __init__(self, spec: TreeSpecPayload, num_chunks: int,
                 template_fn: Optional[Callable[[], Any]]) -> None:
        self.spec = spec
        self.sig = (num_chunks, tuple(m.nbytes for m in spec.leaves))
        self.template_leaves: Optional[List[Any]] = None
        if template_fn is not None:
            # None (one warning) when the sender's tree differs from the
            # template's: index-aligned placement would land leaves wrongly
            self.template_leaves = template_leaves_for(spec, template_fn(), logger)
        n = len(spec.leaves)
        self.buf_lock = threading.Lock()
        self.stats_lock = threading.Lock()
        self.buffers: List[Optional[Any]] = [None] * n
        self.direct = [False] * n
        self.leaves: List[Any] = [None] * n
        self.finished = [False] * n
        self.remaining = [m.nbytes for m in spec.leaves]
        self.chunk_states = [_ChunkFetch(i) for i in range(num_chunks)]

    def _host_target(self, leaf_idx: int) -> Optional[np.ndarray]:
        """The template leaf's own memory as flat uint8, when it is a
        contiguous CPU tensor or a writable ndarray that can absorb the
        leaf: the socket then streams straight into it."""
        meta = self.spec.leaves[leaf_idx]
        if self.template_leaves is None or meta.kind != "array":
            return None
        t = self.template_leaves[leaf_idx]
        if isinstance(t, torch.Tensor) and (t.is_cuda or t.numel() == 0):
            return None
        if not can_absorb(t, meta.shape, meta.dtype, require_contiguous=True):
            return None
        if isinstance(t, torch.Tensor):
            # through .data: a live parameter written by a heal does not
            # fail a backward the healing replica has in flight
            return t.data.reshape(-1).view(torch.uint8).numpy()
        return t.reshape(-1).view(np.uint8)

    def buffer_for(self, leaf_idx: int) -> Any:
        with self.buf_lock:
            if self.buffers[leaf_idx] is None:
                target = self._host_target(leaf_idx)
                if target is not None:
                    self.buffers[leaf_idx] = target
                    self.direct[leaf_idx] = True
                else:
                    self.buffers[leaf_idx] = alloc_leaf(self.spec.leaves[leaf_idx])
            return self.buffers[leaf_idx]

    def mark_written(self, leaf_idx: int, n: int) -> bool:
        """Credit ``n`` verified bytes; True when the leaf is complete."""
        with self.buf_lock:
            self.remaining[leaf_idx] -= n
            if self.remaining[leaf_idx] < 0:
                raise ConnectionError(f"leaf {leaf_idx}: overlapping or duplicate wire ranges")
            return self.remaining[leaf_idx] == 0 and not self.finished[leaf_idx]

    def finish_leaf(self, leaf_idx: int) -> None:
        meta = self.spec.leaves[leaf_idx]
        if self.direct[leaf_idx]:
            leaf = self.template_leaves[leaf_idx]
        else:
            leaf = leaf_from_bytes(meta, self.buffers[leaf_idx])
            if meta.kind == "array" and self.template_leaves is not None:
                # a CUDA template leaf takes one copy into its storage; a
                # mismatch warns "in-place receive degraded"
                leaf = place_leaf_like(leaf, self.template_leaves[leaf_idx], logger)
        self.leaves[leaf_idx] = leaf
        self.finished[leaf_idx] = True
