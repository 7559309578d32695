"""HTTP checkpoint transport: the Manager's default live-recovery path.

Counterpart of ``torchft_tpu/checkpointing/http_transport.py``: a threaded
HTTP server serves ``/checkpoint/{step}/metadata`` and
``/checkpoint/{step}/chunk_{i}``, gated by an RWLock so serving stops while
the optimizer mutates state; a receiver fetches the chunks in parallel.

A chunk body is a run of frames, each a 24-byte ``[leaf_idx, offset,
nbytes]`` header and the raw byte range, written straight from the staged
host copy and read straight into the receiver's per-leaf buffer. Chunks are
byte ranges (``plan_wire_ranges``), so a multi-GB leaf splits across
parallel fetches. The reference's crc32 trailers, mid-stream resume and
multi-source failover are not ported yet: a failed fetch fails the heal,
which the Manager reports and retries at the next quorum.
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional

from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing._serialization import (
    TreeSpecPayload,
    alloc_leaf,
    flatten_state,
    payload_memoryview,
    unflatten_state,
)
from torchft_tpu_torch.checkpointing.transport import (
    CheckpointTransport,
    ChunkStat,
    StreamTimings,
    plan_wire_ranges,
)

logger = logging.getLogger(__name__)

__all__ = ["HTTPTransport"]

_FRAME = struct.Struct("<qqq")  # leaf_idx, offset, nbytes
_CHUNK_BYTES = 32 << 20
# cap on planned chunks: bounds fetch parallelism on huge states
_MAX_CHUNKS = 8


def _to_seconds(timeout: "float | timedelta") -> float:
    return timeout.total_seconds() if isinstance(timeout, timedelta) else float(timeout)


class HTTPTransport(CheckpointTransport):
    """Serve checkpoints over HTTP; receive with parallel chunk fetches.

    ``state_dict_template`` (a zero-arg callable returning a pytree of the
    same structure as the served state) makes received tensor leaves land
    on the template leaves' devices; without one they land on the CPU.
    """

    def __init__(
        self,
        timeout: "float | timedelta" = 60.0,
        hostname: str = "",
        state_dict_template: Optional[Callable[[], Any]] = None,
    ) -> None:
        if state_dict_template is not None and not callable(state_dict_template):
            raise TypeError("state_dict_template must be a zero-arg callable")
        self._timeout = _to_seconds(timeout)
        self._hostname = hostname
        self._template_fn = state_dict_template
        # write-locked whenever there is NO servable checkpoint; in-flight
        # HTTP requests hold the read side
        self._state_lock = RWLock(timeout=self._timeout)
        self._state_lock.w_acquire()
        self._have_state = False
        # (step, spec, payloads, assignments), swapped atomically
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
                self.connection.settimeout(transport._timeout)
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "checkpoint":
                    self.send_error(404, "unknown path")
                    return
                if not transport._state_lock.r_acquire(timeout=transport._timeout):
                    self.send_error(503, "checkpoint not available (locked)")
                    return
                try:
                    staged = transport._staged
                    if staged is None or str(staged[0]) != parts[1]:
                        self.send_error(400, f"not serving step {parts[1]}")
                        return
                    if not transport._respond(self, staged, parts[2]):
                        self.send_error(404, f"unknown resource {parts[2]}")
                except (BrokenPipeError, ConnectionError, TimeoutError, OSError):
                    # receiver gone mid-stream: drop the connection, never
                    # write an error page into a partial body
                    self.close_connection = True
                finally:
                    transport._state_lock.r_release()

        self._server = ThreadingHTTPServer(("0.0.0.0", 0), _Handler)
        self._server.daemon_threads = True
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="torchft_http_ckpt"
        )
        self._serve_thread.start()

    # -- serving ------------------------------------------------------------
    def _respond(self, handler: BaseHTTPRequestHandler, staged: tuple, what: str) -> bool:
        step, spec, payloads, assignments = staged
        if what == "metadata":
            body = pickle.dumps((spec, len(assignments)))
            handler.send_response(200)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
            return True
        if not what.startswith("chunk_"):
            return False
        i = int(what[len("chunk_"):])
        if not 0 <= i < len(assignments):
            return False
        ranges = assignments[i]
        handler.send_response(200)
        handler.send_header(
            "Content-Length", str(sum(_FRAME.size + n for _, _, n in ranges))
        )
        handler.end_headers()
        for leaf_idx, off, n in ranges:
            handler.wfile.write(_FRAME.pack(leaf_idx, off, n))
            handler.wfile.write(payload_memoryview(payloads[leaf_idx])[off:off + n])
        with self._fetch_cond:
            current = self._staged
            if current is not None and current[0] == step:
                self._served_fetches += 1
                self._fetch_cond.notify_all()
        return True

    def metadata(self) -> str:
        host = self._hostname or socket.gethostname()
        return f"http://{host}:{self._server.server_address[1]}"

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any,
        timeout: "float | timedelta",
    ) -> None:
        """Stage a host copy of the state and open the serving window
        (pull-based: "send" makes it available until disallow_checkpoint)."""
        spec, payloads = flatten_state(state_dict)
        nbytes = [m.nbytes for m in spec.leaves]
        chunk_bytes = max(_CHUNK_BYTES, -(-sum(nbytes) // _MAX_CHUNKS))
        assignments = plan_wire_ranges(nbytes, chunk_bytes)
        self._staged = (step, spec, payloads, assignments)
        with self._fetch_cond:
            self._expected_fetches = len(assignments) * len(dst_ranks)
            self._served_fetches = 0
        if not self._have_state:
            self._have_state = True
            self._state_lock.w_release()

    def disallow_checkpoint(self) -> None:
        if not self._have_state:
            return
        # grace window for lagging receivers, bounded so a crashed receiver
        # cannot stall the sender
        with self._fetch_cond:
            self._fetch_cond.wait_for(
                lambda: self._served_fetches >= self._expected_fetches,
                timeout=min(self._timeout, 10.0),
            )
        if not self._state_lock.w_acquire(timeout=self._timeout):
            # a straggler still streaming keeps its snapshot; close the
            # window to new requests and re-lock at the next disallow
            logger.warning("slow checkpoint receiver still streaming")
            self._staged = None
            return
        self._have_state = False
        self._staged = None

    # -- receiving ----------------------------------------------------------
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: "float | timedelta"
    ) -> Any:
        timeout_s = _to_seconds(timeout)
        base = f"{metadata}/checkpoint/{step}"
        with urllib.request.urlopen(f"{base}/metadata", timeout=timeout_s) as r:
            spec, num_chunks = pickle.loads(r.read())
        if not isinstance(spec, TreeSpecPayload):
            raise ConnectionError("bad checkpoint metadata")
        bufs = [alloc_leaf(m) for m in spec.leaves]
        t_start = time.perf_counter()

        def fetch(i: int) -> ChunkStat:
            t0 = time.perf_counter()
            nbytes = 0
            with urllib.request.urlopen(f"{base}/chunk_{i}", timeout=timeout_s) as r:
                while True:
                    hdr = r.read(_FRAME.size)
                    if not hdr:
                        return ChunkStat(nbytes, time.perf_counter() - t0)
                    if len(hdr) != _FRAME.size:
                        raise ConnectionError(f"chunk {i}: truncated frame header")
                    leaf_idx, off, n = _FRAME.unpack(hdr)
                    if not (0 <= leaf_idx < len(bufs) and 0 <= off
                            and off + n <= len(bufs[leaf_idx])):
                        raise ConnectionError(f"chunk {i}: bad frame {leaf_idx, off, n}")
                    span = memoryview(bufs[leaf_idx])[off:off + n]
                    got = 0
                    while got < n:
                        k = r.readinto(span[got:])
                        if not k:
                            raise ConnectionError(f"chunk {i} truncated")
                        got += k
                    nbytes += n

        with ThreadPoolExecutor(max_workers=max(1, min(num_chunks, _MAX_CHUNKS))) as ex:
            chunks = [f.result() for f in [ex.submit(fetch, i) for i in range(num_chunks)]]
        self._last_recv_timings = StreamTimings(
            total_bytes=sum(c.nbytes for c in chunks),
            total_s=time.perf_counter() - t_start, chunks=chunks,
        )
        template = self._template_fn() if self._template_fn is not None else None
        return unflatten_state(spec, bufs, template)

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._serve_thread.join(timeout=5)
