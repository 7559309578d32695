"""Serving plane: health-gated inference workers that pull versioned,
compressed parameter snapshots from the training fleet.

Counterpart of ``torchft_tpu/serving.py``, with the same names::

    trainers ──(commit path)──> SnapshotPublisher ──announce──> SnapshotRegistry
                                    │    │                            │
                              full pulls │ per-step deltas       health poll
                         (HTTPTransport) │ (fp8/int8 wire)      (lighthouse)
                                    ▼    ▼                            │
                                  ServeWorker <──── /serve/sources ───┘
                                    │
                                  /infer traffic

Every live replica publishes a versioned snapshot stamped ``(quorum_id,
step)`` on the commit path. Full snapshots are staged on the checkpoint
transport (``HTTPTransport``: ranged, crc32, multi-source failover); the
per-step deltas ride the bucket codec with the error-feedback discipline
of the allreduce. The publisher keeps a reference ``R`` and replays its own
encoded delta::

    delta_v = encode(params_v - R_{v-1});  R_v = R_{v-1} + decode(delta_v)

Full pulls serve ``R_v`` verbatim, so a worker that walks the delta chain
and one that full-pulls land on bitwise equal flats in every compress mode.
A publisher that missed versions (fresh, healed, or its newest-wins queue
skipped some) re-seats ``R`` on the fleet's chain before it publishes
again: it full-pulls the fleet's newest ``R``, as the reference does, so
every source stays byte-interchangeable. The registry
drains a replica from the serving set at healthwatch's ``warn``, before
its ``eject``; workers answer ``/infer`` from their last applied snapshot
under a local lock, so a reconfiguration or a source's death never fails
a request.

On the card: the publisher's flat, its ``R`` and its delta live on the
parameters' device. ``publish_async`` copies the parameters into a
snapshot buffer reused across versions, on the caller's (training)
stream, and records an event after the copy; the publisher's thread makes
its own stream wait on that event before it reads the buffer, and the next
``publish_async`` makes the training stream wait until the thread has read
it, so neither the next optimizer step nor the next snapshot can tear a
version. An fp8 delta of a CUDA flat is coded there by the host-rule
quantize kernel (``fused_quantize_fp8_host``, K3-host) and replayed into
``R`` by the dequantize kernel (``fused_dequantize_fp8``, K4); only its
codes and scales cross to the host, and ``R`` is staged for full pulls
through page-locked memory. A worker keeps its flat on its device and
decodes each fp8 delta there with K4. ``int8`` and ``off`` run the
reference's host arithmetic wherever the flat lies. The delta record
carries the ``CompressedWire`` without its ``device`` field (the receiver
decodes on its own device), pickled with its arrays out of band
(``load_record``): the codes are never copied into a pickle, on either
side.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import pickle
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch import knobs
from torchft_tpu_torch.bucketing import tree_flatten
from torchft_tpu_torch.observability import MetricsRegistry
from torchft_tpu_torch.ops.quantization import (
    COMPRESS_MODES,
    ROW,
    CompressedWire,
    compress_bucket,
    decode_fp8_on_card,
    decompress_bucket,
    dtype_name,
    fused_dequantize_fp8,
    fused_quantize_fp8_host,
)
from torchft_tpu_torch.retry import RetryPolicy, retry_call
from torchft_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "ServeConfig", "SnapshotRegistry", "RegistryClient", "SnapshotPublisher", "ServeWorker",
    "answer_from_flat", "decode_delta", "delta_nbytes", "encode_delta", "flat_sha256",
    "flatten_params", "layout_signature", "load_record", "pull_full_snapshot",
    "set_serve_fault_hook", "main",
]

# --------------------------------------------------------------------------
# Env contract (registered in knobs.REGISTRY)
# --------------------------------------------------------------------------
SERVE_REGISTRY_ENV = "TORCHFT_SERVE_REGISTRY"
SERVE_MAX_LAG_ENV = "TORCHFT_SERVE_MAX_LAG"
SERVE_COMPRESS_ENV = "TORCHFT_SERVE_COMPRESS"
SERVE_POLL_S_ENV = "TORCHFT_SERVE_POLL_S"
SERVE_DRAIN_ON_ENV = "TORCHFT_SERVE_DRAIN_ON"
SERVE_PORT_ENV = "TORCHFT_SERVE_PORT"
SERVE_TIMEOUT_S_ENV = "TORCHFT_SERVE_TIMEOUT_S"

_DRAIN_POLICIES = ("warn", "eject")
# the publisher's per-version split, one entry per published version
PUBLISH_SPLITS = ("delta_quantize_s", "replay_s", "codes_to_host_s", "pickle_s", "stage_s",
                  "announce_s")
# the newest per-version splits a publisher keeps
_SPLITS_KEPT = 256
# listings a bootstrap tries before it starts a fresh chain: a source
# serves only its newest staged version, so a listing can go stale before
# the pull reaches it
_BOOTSTRAP_LISTINGS = 3

Version = Tuple[int, int]  # (quorum_id, step): lexicographic order


@dataclass
class ServeConfig:
    """Knobs of the serving plane (each overridable by ``TORCHFT_SERVE_*``)."""

    registry: str = ""  # registry base URL ("" = standalone)
    max_lag: int = 8  # delta ring depth; a worker further behind full-pulls
    compress: str = "fp8"  # delta wire: off | fp8 | int8
    poll_s: float = 0.05  # worker poll interval
    drain_on: str = "warn"  # health state that drains a source
    port: int = 0  # worker HTTP port (0 = ephemeral)
    timeout_s: float = 15.0  # per-pull / per-RPC deadline

    @classmethod
    def from_env(cls, **overrides: Any) -> "ServeConfig":
        def _pick(env: str, key: str, cast: Callable[[str], Any]) -> Any:
            if key in overrides and overrides[key] is not None:
                return overrides[key]
            raw = knobs.env_raw(env)
            if raw is None or not raw.strip():
                return getattr(cls, key) if key != "registry" else ""
            try:
                return cast(raw.strip())
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad {env}={raw!r}: {e}") from e

        cfg = cls(
            registry=_pick(SERVE_REGISTRY_ENV, "registry", str),
            max_lag=_pick(SERVE_MAX_LAG_ENV, "max_lag", int),
            compress=_pick(SERVE_COMPRESS_ENV, "compress", str),
            poll_s=_pick(SERVE_POLL_S_ENV, "poll_s", float),
            drain_on=_pick(SERVE_DRAIN_ON_ENV, "drain_on", str),
            port=_pick(SERVE_PORT_ENV, "port", int),
            timeout_s=_pick(SERVE_TIMEOUT_S_ENV, "timeout_s", float),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        self.compress = str(self.compress).strip().lower()
        self.drain_on = str(self.drain_on).strip().lower()
        if self.compress not in COMPRESS_MODES:
            raise ValueError(f"invalid {SERVE_COMPRESS_ENV}={self.compress!r}: "
                             f"expected one of {COMPRESS_MODES}")
        if self.drain_on not in _DRAIN_POLICIES:
            raise ValueError(f"invalid {SERVE_DRAIN_ON_ENV}={self.drain_on!r}: "
                             f"expected one of {_DRAIN_POLICIES}")
        if self.max_lag < 1:
            raise ValueError(f"invalid {SERVE_MAX_LAG_ENV}={self.max_lag}: must be >= 1")
        if self.poll_s <= 0:
            raise ValueError(f"invalid {SERVE_POLL_S_ENV}={self.poll_s}: must be > 0")
        if self.timeout_s <= 0:
            raise ValueError(f"invalid {SERVE_TIMEOUT_S_ENV}={self.timeout_s}: must be > 0")

    def to_json(self) -> Dict[str, Any]:
        return {"registry": self.registry, "max_lag": self.max_lag, "compress": self.compress,
                "poll_s": self.poll_s, "drain_on": self.drain_on, "port": self.port,
                "timeout_s": self.timeout_s}


# --------------------------------------------------------------------------
# Fault hook (test and harness glue, as coordination.set_rpc_fault_hook)
# --------------------------------------------------------------------------
_fault_hook: Optional[Callable[[str, Dict[str, Any]], Optional[str]]] = None
_fault_lock = threading.Lock()


def set_serve_fault_hook(fn: Optional[Callable[[str, Dict[str, Any]], Optional[str]]]) -> None:
    """Install a process-wide serving fault hook (tests and harnesses).

    ``fn(event, info)`` fires at ``"announce"`` (a publisher announced a
    version), ``"delta_request"`` (a delta is about to be served) and
    ``"worker_pull"`` (a worker is about to poll and pull). Returning
    ``"die"`` from a serve-side event drops the connection; the hook may
    also sleep (pull delays) or call back into the harness (kills)."""
    global _fault_hook
    with _fault_lock:
        _fault_hook = fn


def _fire_fault(event: str, info: Dict[str, Any]) -> Optional[str]:
    with _fault_lock:
        fn = _fault_hook
    if fn is None:
        return None
    try:
        return fn(event, info)
    except Exception:  # noqa: BLE001 - a broken hook must not break serving
        logger.exception("serve fault hook failed on %s", event)
        return None


# --------------------------------------------------------------------------
# Flat-vector codec helpers
# --------------------------------------------------------------------------
def _param_leaves(params: Any) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """The leaves of a parameter tree in jax.tree_util's order (dict keys
    sorted; an ``nn.Module`` is its named parameters) as tensors, and their
    layout: shapes and numpy dtype names, so the reference's
    ``flatten_params`` of the same tree has the same ``sig``."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    leaves, _ = tree_flatten(params)
    if not leaves:
        raise ValueError("cannot publish an empty parameter tree")
    tensors: List[torch.Tensor] = []
    layout_leaves: List[List[Any]] = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            layout_leaves.append([list(t.shape), dtype_name(t.dtype)])
        else:
            host = np.asarray(leaf)
            layout_leaves.append([list(host.shape), str(host.dtype)])
            t = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32))
        tensors.append(t)
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"parameters lie on several devices: {sorted(map(str, devices))}")
    layout = {"n": int(sum(t.numel() for t in tensors)), "leaves": layout_leaves}
    layout["sig"] = layout_signature(layout)
    return tensors, layout


def _views(flat: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Consecutive slices of ``flat`` shaped as the leaves."""
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def _fill(views: List[torch.Tensor], leaves: List[torch.Tensor]) -> None:
    """Copy the leaves, cast to f32, into their views of a flat, in one call
    (on the current stream): one Python call for every leaf's copy, so a
    commit path sharing the GIL with other threads pays one hand-off."""
    torch._foreach_copy_(views, leaves)


def flatten_params(params: Any) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One contiguous f32 flat of a parameter tree (a dict of tensors or
    arrays, nested or not, or an ``nn.Module``'s named parameters), leaves
    in jax.tree_util's order, on the parameters' device, and its layout
    (``n``, per-leaf ``[shape, dtype]``, ``sig``). Mismatched sources are
    detected by the layout, not mixed."""
    leaves, layout = _param_leaves(params)
    flat = torch.empty(layout["n"], dtype=torch.float32, device=leaves[0].device)
    _fill(_views(flat, leaves), leaves)
    return flat, layout


def layout_signature(layout: Dict[str, Any]) -> str:
    basis = {"n": layout["n"], "leaves": layout["leaves"]}
    return hashlib.sha1(json.dumps(basis, sort_keys=True).encode()).hexdigest()[:12]


def _host_f32(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32).reshape(-1)


def encode_delta(delta: Any, mode: str) -> Any:
    """Encode a flat f32 delta (a tensor or an array) for the wire: raw f32
    bytes for ``off``, else a ``CompressedWire`` with no ``device``. A CUDA
    delta in fp8 is coded on the card (``compress_bucket``: K3-host); the
    rest by the host codec."""
    if mode == "off":
        return _host_f32(delta).tobytes()
    if isinstance(delta, torch.Tensor):
        delta = delta.detach().reshape(-1)
    else:
        delta = np.ascontiguousarray(delta, dtype=np.float32)
    return compress_bucket(delta, mode, dtype=np.float32)._replace(device=None)


def decode_delta(wire: Any, mode: str, n: int, device: Any = "cpu") -> torch.Tensor:
    """Decode a wire delta back to a flat f32 tensor of length ``n`` on
    ``device``: an fp8 wire for a CUDA device by K4 there, the rest by the
    host codec. This is the decode the publisher replays into ``R``, so
    publisher and workers stay bitwise in lockstep."""
    dev = torch.device(device)
    if mode == "off":
        out = torch.frombuffer(bytearray(wire), dtype=torch.float32)
        out = out.to(dev) if dev.type != "cpu" else out
    elif mode == "fp8" and dev.type == "cuda":
        out = decode_fp8_on_card(wire.payload, wire.scales, wire.n, dev)
    else:
        out = decompress_bucket(wire._replace(device=None), torch.float32)
        out = out.to(dev) if dev.type != "cpu" else out
    if out.numel() != n:
        raise ValueError(f"delta length {out.numel()} != layout n {n}")
    return out


# f32 values a chunk of a card-side decode holds (256 MiB): the decode adds
# each chunk into its target, so no full-size f32 copy of a delta is made
_DECODE_CHUNK = 1 << 26


def _decode_add_(target: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, n: int) -> int:
    """``target[:n] += decode(q, scales)`` on ``target``'s device by K4, a
    chunk of rows at a time on the current stream; the launches made.
    Bitwise ``target + decode_delta(...)``: each value is one product and
    one add either way."""
    q = q.view(torch.uint8).reshape(-1, ROW)
    scales = scales.reshape(-1, 1)
    rows_per = _DECODE_CHUNK // ROW
    launches = 0
    for r0 in range(0, q.shape[0], rows_per):
        a = r0 * ROW
        m = min(n - a, rows_per * ROW)
        if m <= 0:
            break
        target[a:a + m].add_(fused_dequantize_fp8(q[r0:r0 + rows_per], scales[r0:r0 + rows_per],
                                                  m))
        launches += 1
    return launches


def _prepare_delta(wire: Any, mode: str, n: int, device: torch.device) -> Any:
    """What ``_add_delta_`` adds into a flat on ``device``: for an fp8 wire
    and a CUDA device its codes and scales copied there (the K4 decode
    runs at the add), else the decoded f32 delta."""
    if mode == "fp8" and device.type == "cuda":
        q = torch.from_numpy(np.ascontiguousarray(wire.payload)).to(device)
        s = torch.from_numpy(np.ascontiguousarray(wire.scales, dtype=np.float32)).to(device)
        return q, s
    return decode_delta(wire, mode, n, device)


def _add_delta_(target: torch.Tensor, prepared: Any, n: int) -> int:
    """``target += delta`` of a ``_prepare_delta`` result; the K4 launches
    made."""
    if isinstance(prepared, tuple):
        return _decode_add_(target, prepared[0], prepared[1], n)
    target.add_(prepared)
    return 0


def _codes_to_host(q: torch.Tensor, scales: torch.Tensor, n: int,
                   stream: Optional["torch.cuda.Stream"]) -> CompressedWire:
    """The wire of card-side fp8 codes: codes and scales copied to fresh
    host memory (on ``stream``), no ``device``. Pageable: the ring keeps up
    to ``max_lag`` versions' codes, each in a buffer of its own, so
    page-locked memory would be pinned anew at every version."""
    payload = torch.empty(q.shape, dtype=torch.uint8)
    host_scales = torch.empty(scales.numel(), dtype=torch.float32)
    with _stream_ctx(stream):
        payload.copy_(q.view(torch.uint8))
        host_scales.copy_(scales.reshape(-1))
    return CompressedWire("fp8", payload.numpy(), host_scales.numpy(), n, "float32", ROW)


# a delta record's blob: [header length, buffer count] then each buffer's
# length, the pickled header, and the buffers' raw bytes
_BLOB_PREFIX = struct.Struct("<QQ")


def _dump_record(record: Dict[str, Any]) -> List[Any]:
    """A delta record as the parts of its blob: a length prefix, the record
    pickled (protocol 5) with its arrays out of band, then each array's raw
    bytes, so a version's ~1 GB of codes is never copied into a pickle (a
    copy that would hold the GIL the trainers dispatch under)."""
    bufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(record, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    prefix = _BLOB_PREFIX.pack(len(head), len(raws)) + struct.pack(
        f"<{len(raws)}Q", *(r.nbytes for r in raws))
    return [prefix, head, *raws]


def load_record(blob: Any) -> Dict[str, Any]:
    """The delta record of a blob (``_dump_record``'s parts joined, as the
    wire carries them); its arrays view ``blob``'s memory."""
    mv = memoryview(blob)
    head_len, k = _BLOB_PREFIX.unpack_from(mv, 0)
    off = _BLOB_PREFIX.size
    sizes = struct.unpack_from(f"<{k}Q", mv, off)
    off += 8 * k
    head = mv[off:off + head_len]
    off += head_len
    buffers = []
    for n in sizes:
        buffers.append(mv[off:off + n])
        off += n
    return pickle.loads(head, buffers=buffers)


def _read_body(r: Any) -> np.ndarray:
    """A response's body read into one writable uint8 buffer, neither zeroed
    first nor joined after (each would copy a GB under the GIL; the socket
    reads release it)."""
    n = int(r.headers["Content-Length"])
    body = np.empty(n, dtype=np.uint8)
    view, got = memoryview(body), 0
    while got < n:
        k = r.readinto(view[got:])
        if not k:
            raise ConnectionError(f"short body: {got} of {n} bytes")
        got += k
    return body


def delta_nbytes(wire: Any) -> int:
    """Wire size of an encoded delta (codes + scales; raw bytes for off)."""
    if isinstance(wire, (bytes, bytearray, memoryview)):
        return len(wire)
    return int(wire.payload.nbytes + wire.scales.nbytes)


def answer_from_flat(flat: Any, seed: int) -> Optional[float]:
    """Deterministic toy inference: a strided dot over the parameter flat
    (a tensor on any device, or an array). The 128-element window is
    copied to the host and summed in float64 there, so two workers at the
    same version answer bit for bit as the reference does."""
    if flat is None:
        return None
    n = int(flat.numel() if isinstance(flat, torch.Tensor) else flat.size)
    if n == 0:
        return None
    k = min(128, n)
    start = (int(seed) * 2654435761) % max(1, n - k + 1)
    window = flat[start:start + k]
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    weights = np.cos(np.arange(k, dtype=np.float64) * 0.1)
    return float(np.dot(np.asarray(window).astype(np.float64), weights))


def flat_sha256(flat: torch.Tensor) -> str:
    """sha256 of a flat's f32 bytes (one copy to the host; the digest a
    run prints for each worker's flat and each publisher's ``R``)."""
    host = flat.detach().reshape(-1).to(torch.float32).cpu().contiguous()
    return hashlib.sha256(host.view(torch.uint8).numpy()).hexdigest()


def _json_body(handler: BaseHTTPRequestHandler) -> Dict[str, Any]:
    length = int(handler.headers.get("Content-Length", 0) or 0)
    raw = handler.rfile.read(length) if length else b"{}"
    return json.loads(raw.decode() or "{}")


def _send_json(handler: BaseHTTPRequestHandler, code: int, obj: Dict[str, Any]) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _send_parts(handler: BaseHTTPRequestHandler, parts: List[Any]) -> None:
    handler.send_response(200)
    handler.send_header("Content-Type", "application/octet-stream")
    handler.send_header("Content-Length", str(sum(memoryview(p).nbytes for p in parts)))
    handler.end_headers()
    for p in parts:
        handler.wfile.write(p)


def _send_metrics(handler: BaseHTTPRequestHandler, registry: MetricsRegistry) -> None:
    body = registry.render().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def _http_json(url: str, payload: Optional[Dict[str, Any]] = None,
               timeout: float = 5.0) -> Tuple[int, Dict[str, Any]]:
    """One JSON request; returns (status, body). 4xx bodies are parsed, not
    raised: the registry speaks structured 409s."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except Exception:  # noqa: BLE001
            return e.code, {}


def _stream_ctx(stream: Optional["torch.cuda.Stream"]) -> Any:
    """``torch.cuda.stream(stream)``, or nothing for a CPU flat."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _QuietHandler(BaseHTTPRequestHandler):
    """A request handler that logs at debug level under ``_label``."""

    _label = "serve"

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug(self._label + ": " + fmt, *args)


def _start_server(host: str, port: int, handler: type, name: str
                  ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True, name=name)
    thread.start()
    return server, thread


def _stop_server(server: ThreadingHTTPServer, thread: Optional[threading.Thread]) -> None:
    try:
        server.shutdown()
        server.server_close()
    except Exception:  # noqa: BLE001 - teardown must not raise
        pass
    if thread is not None and thread is not threading.current_thread():
        thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# SnapshotRegistry: beside the lighthouse, health-gates routing
# --------------------------------------------------------------------------
class SnapshotRegistry:
    """Tracks which replicas can serve which snapshot version and orders
    them for workers, drained sources last.

    Each registry instance mints a fresh ``epoch``; announcements carry the
    epoch their publisher registered under and a per-publisher monotonic
    ``seq``. After a registry (lighthouse) restart every old announcement
    gets 409 ``stale_epoch`` until the publisher registers again, so a
    replayed or delayed announce never resurrects pre-restart state."""

    def __init__(
        self,
        lighthouse_addr: Optional[str] = None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        drain_on: str = "warn",
        poll_s: float = 0.25,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        if drain_on not in _DRAIN_POLICIES:
            raise ValueError(f"drain_on must be one of {_DRAIN_POLICIES}, got {drain_on!r}")
        self._lock = threading.Lock()
        self.epoch = uuid.uuid4().hex[:12]
        self._drain_on = drain_on
        self._poll_s = poll_s
        self._lighthouse_addr = lighthouse_addr
        self._health_fn = health_fn
        # replica_id -> {version, seq, full_url, delta_url, chain, announced_at}
        self._sources: Dict[str, Dict[str, Any]] = {}
        self._registered: Dict[str, str] = {}  # replica_id -> epoch granted
        self._drained_health: Dict[str, str] = {}  # replica_id -> state name
        self._drained_manual: set = set()
        self._counters: Dict[str, int] = {"announce_total": 0, "announce_rejected_total": 0,
                                          "drain_transitions_total": 0}
        self._metrics = MetricsRegistry()
        self._stop = threading.Event()
        registry = self

        class _Handler(_QuietHandler):
            _label = "serve_registry"

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                try:
                    path = self.path.partition("?")[0]
                    if path == "/serve/sources":
                        _send_json(self, 200, registry.sources())
                    elif path == "/serve/status":
                        _send_json(self, 200, registry.status())
                    elif path in ("/metrics", "/"):
                        registry._refresh_metrics()
                        _send_metrics(self, registry._metrics)
                    else:
                        self.send_error(404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("serve_registry GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self) -> None:  # noqa: N802 - http.server API
                try:
                    path = self.path.partition("?")[0]
                    body = _json_body(self)
                    if path == "/serve/register":
                        code, resp = registry.register(str(body["replica_id"]))
                    elif path == "/serve/announce":
                        code, resp = registry.announce(body)
                    elif path == "/serve/drain":
                        code, resp = registry.drain(str(body["replica_id"]),
                                                    bool(body.get("drain", True)))
                    else:
                        self.send_error(404)
                        return
                    _send_json(self, code, resp)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("serve_registry POST failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

        self._server, self._serve_thread = _start_server(host, port, _Handler,
                                                         "torchft_serve_registry")
        self._poll_thread: Optional[threading.Thread] = None
        if lighthouse_addr or health_fn is not None:
            self._poll_thread = threading.Thread(target=self._health_poll_loop, daemon=True,
                                                 name="torchft_serve_registry_health")
            self._poll_thread.start()

    # -- public api --------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def register(self, replica_id: str) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            self._registered[replica_id] = self.epoch
            return 200, {"epoch": self.epoch}

    def announce(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        try:
            replica_id = str(body["replica_id"])
            epoch = str(body["epoch"])
            seq = int(body["seq"])
            version: Version = (int(body["quorum_id"]), int(body["step"]))
            full_url = str(body["full_url"])
            delta_url = str(body["delta_url"])
            chain = str(body["chain"])
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"malformed announce: {e}"}
        with self._lock:
            self._counters["announce_total"] += 1
            if epoch != self.epoch:
                # a publisher of an earlier registry: it registers again
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_epoch", "epoch": self.epoch}
            prior = self._sources.get(replica_id)
            if prior is not None and seq <= prior["seq"]:
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_seq", "have_seq": prior["seq"]}
            if prior is not None and version <= tuple(prior["version"]):
                # versions are strictly monotone per replica: a reconfigure
                # bumps quorum_id, never rewinds the pair
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_version", "have": list(prior["version"])}
            self._sources[replica_id] = {"version": list(version), "seq": seq,
                                         "full_url": full_url, "delta_url": delta_url,
                                         "chain": chain, "announced_at": time.time()}
            return 200, {"ok": True, "latest": self._latest_locked()}

    def drain(self, replica_id: str, drain: bool) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            before = replica_id in self._drained_manual
            if drain:
                self._drained_manual.add(replica_id)
            else:
                self._drained_manual.discard(replica_id)
            if before != drain:
                self._counters["drain_transitions_total"] += 1
            return 200, {"ok": True, "draining": sorted(self._all_drained_locked())}

    def forget(self, replica_id: str) -> None:
        with self._lock:
            self._sources.pop(replica_id, None)
            self._registered.pop(replica_id, None)

    def sources(self) -> Dict[str, Any]:
        """The ordered source list for workers: healthy sources first (the
        newest version first, then by replica id), drained ones at the tail,
        so a fully drained fleet still serves rather than failing
        requests."""
        with self._lock:
            drained = self._all_drained_locked()
            entries = [{"replica_id": rid, "version": list(src["version"]),
                        "full_url": src["full_url"], "delta_url": src["delta_url"],
                        "chain": src["chain"], "draining": rid in drained}
                       for rid, src in self._sources.items()]
            entries.sort(key=lambda e: (e["draining"], [-e["version"][0], -e["version"][1]],
                                        e["replica_id"]))
            latest = self._latest_locked()
            chain = None
            if latest is not None:
                chain = next((e["chain"] for e in entries if e["version"] == latest), None)
            return {"epoch": self.epoch, "latest": latest, "chain": chain, "sources": entries,
                    "draining": sorted(drained)}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self.epoch, "drain_on": self._drain_on,
                    "sources": dict(self._sources), "drained_health": dict(self._drained_health),
                    "drained_manual": sorted(self._drained_manual),
                    "counters": dict(self._counters)}

    def shutdown(self) -> None:
        self._stop.set()
        _stop_server(self._server, self._serve_thread)
        if self._poll_thread is not None and self._poll_thread is not threading.current_thread():
            self._poll_thread.join(timeout=5.0)

    # -- internals ---------------------------------------------------------
    def _all_drained_locked(self) -> set:
        return set(self._drained_health) | self._drained_manual

    def _latest_locked(self) -> Optional[List[int]]:
        drained = self._all_drained_locked()
        pool = [src["version"] for rid, src in self._sources.items() if rid not in drained] \
            or [src["version"] for src in self._sources.values()]
        best: Optional[List[int]] = None
        for v in pool:
            if best is None or tuple(v) > tuple(best):
                best = v
        return best

    def _health_poll_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                health = self._poll_health()
            except Exception:  # noqa: BLE001 - keep serving on a failed poll
                logger.debug("serve_registry health poll failed", exc_info=True)
                continue
            if health is not None:
                self.apply_health(health)

    def _poll_health(self) -> Optional[Dict[str, Any]]:
        if self._health_fn is not None:
            return self._health_fn()
        # lazy: coordination imports this module for the co-hosted registry
        from torchft_tpu_torch.coordination import LighthouseClient

        assert self._lighthouse_addr is not None
        return LighthouseClient(self._lighthouse_addr, connect_timeout=2.0).health()

    def apply_health(self, health: Dict[str, Any]) -> None:
        """Fold one ``/health`` summary into the drain set (split out of the
        poll loop so tests drive escalations deterministically)."""
        from torchft_tpu_torch.healthwatch import serving_eligible

        replicas = health.get("replicas", {}) or {}
        with self._lock:
            next_drained: Dict[str, str] = {}
            for rid, info in replicas.items():
                state = info.get("state", "ok")
                if not serving_eligible(state, drain_on=self._drain_on):
                    next_drained[rid] = str(state)
            # an excluded replica may vanish from the replicas map: it stays
            # drained
            for rid in health.get("excluded", []) or []:
                next_drained.setdefault(str(rid), "excluded")
            if set(next_drained) != set(self._drained_health):
                self._counters["drain_transitions_total"] += 1
                logger.info("serve_registry drain set -> %s", sorted(next_drained))
            self._drained_health = next_drained

    def _refresh_metrics(self) -> None:
        with self._lock:
            drained = self._all_drained_locked()
            latest = self._latest_locked()
            n_sources = len(self._sources)
            counters = dict(self._counters)
        m = self._metrics
        m.gauge_set("serve_draining", float(len(drained)),
                    "Sources currently drained from the serving set.")
        m.gauge_set("serve_sources", float(n_sources),
                    "Sources announced to the snapshot registry.")
        m.gauge_set("serve_latest_step", float(latest[1]) if latest else -1.0,
                    "Step of the newest announced snapshot.")
        for name, val in counters.items():
            m.counter_set(f"serve_registry_{name}", float(val))


# --------------------------------------------------------------------------
# RegistryClient: the retrying JSON client of publishers and workers
# --------------------------------------------------------------------------
class RegistryClient:
    """Thin retrying client of the registry's JSON API. Transport errors
    retry under ``TORCHFT_RETRY_*``; structured 4xx answers (stale_epoch and
    the like) return to the caller at once: protocol, not weather."""

    def __init__(self, base_url: str, timeout: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None) -> None:
        self.base_url = base_url.rstrip("/")
        self._timeout = timeout
        self._policy = retry_policy if retry_policy is not None else RetryPolicy.from_env()

    def _call(self, path: str, payload: Optional[Dict[str, Any]] = None
              ) -> Tuple[int, Dict[str, Any]]:
        def attempt(remaining: float) -> Tuple[int, Dict[str, Any]]:
            return _http_json(f"{self.base_url}{path}", payload,
                              timeout=min(self._timeout, max(remaining, 0.05)))

        return retry_call(attempt, policy=self._policy, timeout=self._timeout,
                          retryable=(OSError, TimeoutError, ConnectionError, ValueError))

    def register(self, replica_id: str) -> str:
        code, resp = self._call("/serve/register", {"replica_id": replica_id})
        if code != 200:
            raise RuntimeError(f"register failed: {code} {resp}")
        return str(resp["epoch"])

    def announce(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        return self._call("/serve/announce", body)

    def sources(self) -> Dict[str, Any]:
        code, resp = self._call("/serve/sources")
        if code != 200:
            raise RuntimeError(f"sources failed: {code} {resp}")
        return resp

    def drain(self, replica_id: str, drain: bool = True) -> Dict[str, Any]:
        code, resp = self._call("/serve/drain", {"replica_id": replica_id, "drain": drain})
        if code != 200:
            raise RuntimeError(f"drain failed: {code} {resp}")
        return resp


# --------------------------------------------------------------------------
# SnapshotPublisher: rides the commit path on each live replica
# --------------------------------------------------------------------------
class SnapshotPublisher:
    """Publishes versioned parameter snapshots of one training replica.

    Full snapshots are staged on the checkpoint transport (the wire heals
    ride); each version's delta is encoded once and kept in a ring of the
    last ``max_lag`` versions. ``R`` (module docstring) is what full pulls
    serve, so delta walks and full pulls are bitwise equal. ``R``, the
    snapshot buffer and the delta live on the parameters' device.
    ``splits`` holds each published version's seconds by stage
    (``PUBLISH_SPLITS``, the newest 256)."""

    def __init__(self, replica_id: str, config: Optional[ServeConfig] = None,
                 registry_url: Optional[str] = None, hostname: str = "127.0.0.1") -> None:
        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

        self.replica_id = replica_id
        self.cfg = config if config is not None else ServeConfig.from_env()
        url = registry_url if registry_url is not None else self.cfg.registry
        self._registry = RegistryClient(url, timeout=self.cfg.timeout_s) if url else None
        self._epoch: Optional[str] = None
        self._seq = 0
        self._lock = threading.Lock()
        # one publish at a time (the thread, or a synchronous publish())
        self._publish_lock = threading.Lock()
        self._ref: Optional[torch.Tensor] = None
        self._version: Optional[Version] = None
        self._layout: Optional[Dict[str, Any]] = None
        self._chain: Optional[str] = None
        # version -> (its record's blob as parts, its prev)
        self._deltas: "OrderedDict[Version, Tuple[List[Any], Optional[Version]]]" = OrderedDict()
        # k3_host_launches / k4_launches: the kernels this publisher had
        # launched (counted in ops.quantization.LAUNCHES too)
        self.counters: Dict[str, int] = {"published_total": 0, "bootstrap_pulls_total": 0,
                                         "announce_rejected_total": 0, "delta_bytes_total": 0,
                                         "skipped_total": 0, "k3_host_launches": 0, "k4_launches": 0}
        self.splits: List[Dict[str, float]] = []
        self._killed = False
        self._stream: Optional[torch.cuda.Stream] = None
        # full snapshots ride the checkpoint transport verbatim
        self._transport = HTTPTransport(timeout=self.cfg.timeout_s, hostname=hostname)
        publisher = self

        class _Handler(_QuietHandler):
            _label = "serve_publisher"

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                try:
                    parts = self.path.partition("?")[0].strip("/").split("/")
                    # /serve/delta/{quorum_id}/{step} | /serve/manifest
                    if parts[:2] == ["serve", "manifest"]:
                        _send_json(self, 200, publisher.manifest())
                        return
                    if len(parts) == 4 and parts[:2] == ["serve", "delta"]:
                        version = (int(parts[2]), int(parts[3]))
                        action = _fire_fault("delta_request", {
                            "replica_id": publisher.replica_id, "version": version})
                        if action == "die":
                            self.close_connection = True
                            return
                        parts = publisher._delta_parts(version)
                        if parts is None:
                            self.send_error(404, "delta not retained")
                            return
                        _send_parts(self, parts)
                        return
                    self.send_error(404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("serve_publisher GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

        self._delta_server, self._delta_thread = _start_server(hostname, 0, _Handler,
                                                               "torchft_serve_publisher")
        # publish_async's snapshot buffer, reused across versions: the
        # training stream writes it after the thread's last read of it
        # (``_consumed``), the thread reads it after the copy (the item's
        # event); ``_snap_gen`` names the version it holds
        self._snap_lock = threading.Lock()
        self._snap: Optional[torch.Tensor] = None
        self._snap_views: List[torch.Tensor] = []
        self._snap_sig: Optional[str] = None
        self._snap_gen = 0
        self._consumed: Optional[torch.cuda.Event] = None
        # the newest pending (quorum_id, step, layout, generation, event)
        self._queue_lock = threading.Lock()
        self._queue_item: Optional[Tuple[int, int, Dict[str, Any], int, Any]] = None
        self._queue_event = threading.Event()
        self._busy = False
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._publish_loop, daemon=True,
                                        name="torchft_serve_publish")
        self._worker.start()

    # -- addresses ---------------------------------------------------------
    @property
    def full_url(self) -> str:
        return self._transport.metadata()

    @property
    def delta_url(self) -> str:
        host, port = self._delta_server.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def version(self) -> Optional[Version]:
        with self._lock:
            return self._version

    @property
    def chain(self) -> Optional[str]:
        with self._lock:
            return self._chain

    def ref_flat(self) -> Optional[torch.Tensor]:
        """A copy of ``R`` on its device (None before the first publish)."""
        with self._lock:
            if self._ref is None:
                return None
            with self._on_stream():
                out = self._ref.clone()
            self._sync()
            return out

    def manifest(self) -> Dict[str, Any]:
        """The chain, mode, version and layout, and the retained deltas'
        versions oldest first with, beside them, each one's ``prev``."""
        with self._lock:
            return {"replica_id": self.replica_id, "chain": self._chain,
                    "mode": self.cfg.compress,
                    "version": list(self._version) if self._version else None,
                    "layout_sig": self._layout["sig"] if self._layout else None,
                    "deltas": [list(v) for v in self._deltas],
                    "prevs": [list(p) if p else None for _, p in self._deltas.values()]}

    def delta_blob(self, version: Version) -> Optional[bytes]:
        """The blob a worker fetches for ``version`` (``load_record``
        reads it), or None when it is not retained."""
        parts = self._delta_parts(version)
        return None if parts is None else b"".join(parts)

    def _delta_parts(self, version: Version) -> Optional[List[Any]]:
        with self._lock:
            entry = self._deltas.get(tuple(version))
            return entry[0] if entry is not None else None

    # -- device helpers ----------------------------------------------------
    def _on_stream(self) -> Any:
        return _stream_ctx(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _ensure_stream(self, device: torch.device) -> None:
        if device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device)

    # -- publishing --------------------------------------------------------
    def publish(self, quorum_id: int, step: int, params: Any) -> Optional[Version]:
        """Publish one committed snapshot synchronously. Returns the
        published version, or None when it was already covered (a
        co-publisher got there first and this one adopted its state)."""
        flat, layout = flatten_params(params)
        return self._publish_flat(int(quorum_id), int(step), flat, layout)

    def publish_async(self, quorum_id: int, step: int, params: Any) -> None:
        """Commit-path entry: copy the parameters into the snapshot buffer
        now, on the caller's stream (so the next step cannot tear them);
        encode and announce on the publisher's thread. Keeps only the newest
        pending version: the chain's ``prev`` pointers make a skipped
        version safe for delta walkers (``counters["skipped_total"]``)."""
        leaves, layout = _param_leaves(params)
        dev = leaves[0].device
        self._ensure_stream(dev)
        with self._snap_lock:
            cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
            if cur is not None and self._consumed is not None:
                # the thread's last read of the buffer comes first
                cur.wait_event(self._consumed)
            buf = self._snap
            if buf is None or buf.numel() != layout["n"] or buf.device != dev \
                    or self._snap_sig != layout["sig"]:
                buf = self._snap = torch.empty(layout["n"], dtype=torch.float32, device=dev)
                self._snap_views = _views(buf, leaves)
                self._snap_sig = layout["sig"]
            _fill(self._snap_views, leaves)
            ready = None
            if cur is not None:
                ready = torch.cuda.Event()
                ready.record(cur)
            self._snap_gen += 1
            item = (int(quorum_id), int(step), layout, self._snap_gen, ready)
        with self._queue_lock:
            if self._queue_item is not None:
                self.counters["skipped_total"] += 1
            self._queue_item = item
        self._queue_event.set()

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until the async queue is drained and its last item
        published."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._queue_lock:
                idle = self._queue_item is None and not self._busy
            if idle and not self._queue_event.is_set():
                return True
            time.sleep(0.005)
        return False

    def _publish_loop(self) -> None:
        while not self._stop.is_set():
            self._queue_event.wait(0.1)
            if self._stop.is_set():
                return
            with self._queue_lock:
                item = self._queue_item
                self._queue_item = None
                if item is None:
                    self._queue_event.clear()
                    continue
                self._busy = True
            try:
                quorum_id, step, layout, gen, ready = item
                self._publish_flat(quorum_id, step, None, layout, gen=gen, ready=ready)
            except Exception:  # noqa: BLE001 - the advisory plane must not die
                logger.exception("async snapshot publish failed")
            finally:
                with self._queue_lock:
                    self._busy = False

    def _reset_chain_locked(self) -> None:
        self._ref = None
        self._version = None
        self._chain = None
        self._deltas.clear()

    def _publish_flat(self, quorum_id: int, step: int, flat: Optional[torch.Tensor],
                      layout: Dict[str, Any], gen: Optional[int] = None,
                      ready: Any = None) -> Optional[Version]:
        """Publish ``flat`` (None: the snapshot buffer of generation
        ``gen``, ready after the event ``ready``) as ``(quorum_id, step)``."""
        with self._publish_lock:
            return self._publish_locked(quorum_id, step, flat, layout, gen, ready)

    def _publish_locked(self, quorum_id: int, step: int, flat: Optional[torch.Tensor],
                        layout: Dict[str, Any], gen: Optional[int], ready: Any
                        ) -> Optional[Version]:
        version: Version = (quorum_id, step)
        device = flat.device if flat is not None else self._snap.device
        self._ensure_stream(device)
        with self._lock:
            if self._killed:
                return None
            if self._layout is not None and layout["sig"] != self._layout["sig"]:
                # model surgery: deltas cannot bridge layouts; workers full-pull
                logger.warning("parameter layout changed (%s -> %s); resetting serve chain",
                               self._layout["sig"], layout["sig"])
                self._reset_chain_locked()
            self._layout = layout
        # a publisher behind the registry (fresh, healed, or one that skipped
        # versions) re-seats R on the fleet's chain, or its deltas fork it
        self._maybe_bootstrap(version, layout, device)
        with self._lock:
            if self._killed:
                return None
            if self._version is not None and version <= self._version:
                return None  # covered: the bootstrap adopted >= version
            if self._chain is None:
                # a deterministic chain id: replicas seeding the chain from
                # identical state mint identical ids, so either's deltas
                # extend the other's
                self._chain = f"{self.cfg.compress}-{layout['sig']}-{quorum_id}.{step}"
                with self._on_stream():
                    self._ref = torch.zeros(layout["n"], dtype=torch.float32, device=device)
                self._version = None
            prev = self._version
            chain = self._chain
            ref = self._ref
        n = layout["n"]
        split: Dict[str, float] = {}
        t0 = time.perf_counter()
        if flat is None:
            with self._snap_lock:
                if gen != self._snap_gen:
                    # publish_async wrote a newer version into the buffer
                    # after this one was taken: that one is queued
                    with self._queue_lock:
                        self.counters["skipped_total"] += 1
                    return None
                with self._on_stream():
                    if ready is not None:
                        self._stream.wait_event(ready)
                    # the delta in place of the snapshot: the buffer is read
                    # for the last time by the quantize
                    wire, q, s = self._quantize(self._snap.sub_(ref))
                    if self._stream is not None:
                        self._consumed = torch.cuda.Event()
                        self._consumed.record(self._stream)
        else:
            with self._on_stream():
                wire, q, s = self._quantize(flat.to(torch.float32).reshape(-1).sub_(ref))
        self._sync()
        split["delta_quantize_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        with self._on_stream():
            # replay our own decode: R_v = R_{v-1} + decode(delta_v) is what
            # every worker computes
            if q is not None:
                self.counters["k4_launches"] += _decode_add_(ref, q, s, n)
            else:
                ref.add_(decode_delta(wire, self.cfg.compress, n, ref.device))
        self._sync()
        split["replay_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if q is not None:
            wire = _codes_to_host(q, s, n, self._stream)
            del q, s
        split["codes_to_host_s"] = time.perf_counter() - t
        t = time.perf_counter()
        record = {"v": 1, "chain": chain, "quorum_id": quorum_id, "step": step,
                  "prev": list(prev) if prev is not None else None, "mode": self.cfg.compress,
                  "layout_sig": layout["sig"], "n": n, "wire": wire}
        parts = _dump_record(record)
        split["pickle_s"] = time.perf_counter() - t
        with self._lock:
            if self._killed:
                return None
            self._version = version
            self._deltas[version] = (parts, prev)
            while len(self._deltas) > self.cfg.max_lag:
                self._deltas.popitem(last=False)
            self.counters["published_total"] += 1
            self.counters["delta_bytes_total"] += delta_nbytes(wire)
            meta = {"quorum_id": quorum_id, "step": step, "chain": chain,
                    "mode": self.cfg.compress, "layout": json.dumps(layout)}
        del wire, record, parts
        t = time.perf_counter()
        self._stage(step, ref, meta)
        split["stage_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._announce(version)
        split["announce_s"] = time.perf_counter() - t
        with self._lock:
            self.splits.append(split)
            del self.splits[:-_SPLITS_KEPT]
        _fire_fault("announce", {"replica_id": self.replica_id, "version": version,
                                 "publisher": self})
        return version

    def _quantize(self, delta: torch.Tensor) -> Tuple[Any, Optional[torch.Tensor],
                                                      Optional[torch.Tensor]]:
        """(wire, None, None), or for a CUDA delta in fp8 (None, codes,
        scales) on the card: one K3-host launch."""
        if delta.is_cuda and self.cfg.compress == "fp8":
            q, s, _ = fused_quantize_fp8_host(delta)
            self.counters["k3_host_launches"] += 1
            return None, q, s
        return encode_delta(delta, self.cfg.compress), None, None

    def _stage(self, step: int, ref: torch.Tensor, meta: Dict[str, Any]) -> None:
        """Stage a host copy of ``R`` for full pulls (``dst_ranks=[]``: the
        serving window is pull-based and never closed here). A CUDA ``R``
        is copied into fresh page-locked memory, handed to the transport
        without a further copy."""
        if ref.is_cuda:
            host = torch.empty(ref.shape, dtype=torch.float32, pin_memory=True)
            with self._on_stream():
                host.copy_(ref)
        else:
            host = ref.clone()
        self._transport.send_checkpoint(dst_ranks=[], step=step,
                                        state_dict={"flat": host, "meta": meta},
                                        timeout=self.cfg.timeout_s, snapshot=False)

    def _maybe_bootstrap(self, version: Version, layout: Dict[str, Any],
                         device: torch.device) -> None:
        if self._registry is None:
            return
        for _ in range(_BOOTSTRAP_LISTINGS):
            try:
                listing = self._registry.sources()
            except Exception:  # noqa: BLE001 - registry down: publish standalone
                logger.debug("registry sources unavailable", exc_info=True)
                return
            latest = listing.get("latest")
            if latest is None:
                return
            latest_v: Version = (int(latest[0]), int(latest[1]))
            with self._lock:
                ours = self._version
                chain = self._chain
            others = [s for s in listing.get("sources", []) if s["replica_id"] != self.replica_id]
            if ours is not None and chain == listing.get("chain"):
                if ours >= latest_v:
                    return  # the tip (or beyond): delta as usual
                same = [s for s in others if s["chain"] == chain]
                if latest_v == version and self._tip_extends(same, ours, version):
                    # a co-publisher just published the version we are about
                    # to, from our version: our delta is byte-identical to its
                    return
            if not others:
                return  # the registry knows only us: nothing to re-seat on
            try:
                flat, meta = pull_full_snapshot(others, latest_v, timeout=self.cfg.timeout_s)
            except Exception:  # noqa: BLE001
                # the sources staged a newer version after the listing (a
                # source serves its newest only): list again
                logger.info("serve bootstrap pull of %s failed; listing again", latest_v,
                            exc_info=True)
                continue
            self._adopt(flat, meta, layout, device)
            return
        logger.warning("serve bootstrap pull failed %d times; starting a fresh chain",
                       _BOOTSTRAP_LISTINGS)
        with self._lock:
            self._reset_chain_locked()

    def _adopt(self, flat: torch.Tensor, meta: Dict[str, Any], layout: Dict[str, Any],
               device: torch.device) -> None:
        """Re-seat ``R`` on a full pull's flat (a fresh chain when the
        fleet's layout or mode is not ours)."""
        got_layout = json.loads(meta["layout"])
        with self._lock:
            if got_layout["sig"] != layout["sig"] or meta["mode"] != self.cfg.compress:
                self._reset_chain_locked()
                return
            with self._on_stream():
                ref = flat.to(device=device, dtype=torch.float32).reshape(-1)
                # a CPU flat may come back as the receive buffer itself
                self._ref = ref.clone() if ref.data_ptr() == flat.data_ptr() else ref
            self._sync()
            self._version = (int(meta["quorum_id"]), int(meta["step"]))
            self._chain = meta["chain"]
            self._deltas.clear()  # our old ring forked from a stale ref
            self.counters["bootstrap_pulls_total"] += 1

    def _tip_extends(self, sources: List[Dict[str, Any]], ours: Version, version: Version) -> bool:
        """Whether a source at ``version`` published it with ``prev`` =
        ``ours`` (its manifest's ``prevs``)."""
        for src in sources:
            if tuple(src["version"]) != version:
                continue
            try:
                with urllib.request.urlopen(f"{src['delta_url']}/serve/manifest",
                                            timeout=self.cfg.timeout_s) as r:
                    manifest = json.loads(r.read().decode())
            except Exception:  # noqa: BLE001 - the next source
                continue
            for v, p in zip(manifest.get("deltas", []), manifest.get("prevs", [])):
                if tuple(v) == version:
                    return p is not None and tuple(p) == ours
        return False

    def _announce(self, version: Version) -> None:
        if self._registry is None:
            return
        for attempt in range(2):
            try:
                if self._epoch is None:
                    self._epoch = self._registry.register(self.replica_id)
                self._seq += 1
                code, resp = self._registry.announce({
                    "replica_id": self.replica_id, "epoch": self._epoch, "seq": self._seq,
                    "quorum_id": version[0], "step": version[1], "full_url": self.full_url,
                    "delta_url": self.delta_url, "chain": self.chain})
            except Exception:  # noqa: BLE001 - registry down: serve anyway
                logger.warning("snapshot announce failed", exc_info=True)
                return
            if code == 200:
                return
            if resp.get("error") == "stale_epoch" and attempt == 0:
                # the registry (lighthouse) restarted: register under its new
                # epoch and announce once more
                self._epoch = None
                self._seq = 0
                continue
            self.counters["announce_rejected_total"] += 1
            logger.info("announce rejected: %s", resp)
            return

    # -- lifecycle ---------------------------------------------------------
    def kill(self) -> None:
        """Die abruptly: both serve endpoints vanish and nothing is
        deregistered (the registry learns through health or a drain)."""
        with self._lock:
            self._killed = True
        self._stop.set()
        self._queue_event.set()
        _stop_server(self._delta_server, self._delta_thread)
        try:
            self._transport.shutdown(wait=False)
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self) -> None:
        """``kill``, then join the publisher thread and drop the device
        state (``R``, the snapshot buffer)."""
        self.kill()
        if self._worker is not threading.current_thread():
            self._worker.join(timeout=max(self.cfg.timeout_s, 5.0))
        self._sync()
        with self._lock:
            self._ref = None
        with self._snap_lock:
            self._snap = None
            self._snap_views = []
            self._consumed = None


# --------------------------------------------------------------------------
# Full-pull client helper (shared by workers and bootstrapping publishers)
# --------------------------------------------------------------------------
def pull_full_snapshot(sources: List[Dict[str, Any]], version: Version, timeout: float = 15.0,
                       on_event: Optional[Callable[..., None]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Ranged, resumable, multi-source full pull of snapshot ``version``
    over ``HTTPTransport.recv_checkpoint_multi``: byte-range chunks, crc32
    trailers, mid-transfer failover across the registry's ordered source
    list. Returns ``(flat, meta)``, the flat an f32 CPU tensor; raises if
    every source is exhausted."""
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    if not sources:
        raise RuntimeError("no snapshot sources available")
    receiver = HTTPTransport(timeout=timeout, client_only=True)
    pairs = [(s["replica_id"], (lambda u=s["full_url"]: u)) for s in sources]
    state = receiver.recv_checkpoint_multi(pairs, step=version[1], timeout=timeout,
                                           on_event=on_event)
    timings = receiver.last_recv_timings()
    flat = state["flat"].reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    meta = dict(state["meta"])
    meta["_bytes"] = int(timings.total_bytes) if timings else flat.numel() * 4
    meta["_failovers"] = int(timings.failovers) if timings else 0
    meta["_seconds"] = float(timings.total_s) if timings else 0.0
    got = (int(meta["quorum_id"]), int(meta["step"]))
    if got < tuple(version):
        raise RuntimeError(f"stale full snapshot: asked {version}, sources serve {got}")
    return flat, meta


# --------------------------------------------------------------------------
# ServeWorker: answers traffic from the last applied snapshot
# --------------------------------------------------------------------------
class ServeWorker:
    """One inference worker: pulls snapshots in the background and answers
    ``/infer`` from the last applied version under a local lock.

    The request path never touches the network, so registry convergence,
    a source's death and quorum reconfigurations cannot fail a request.
    The flat lives on ``device`` (``cuda`` unless the caller asks for the
    CPU), where each fp8 delta is decoded (K4) and added in place; on the
    card the worker's copies and kernels run on a stream of its own, so
    ``/infer`` does not wait behind the trainers' queue. ``full_pull_s``
    holds each full pull's seconds."""

    def __init__(self, registry_url: str, config: Optional[ServeConfig] = None,
                 name: Optional[str] = None, start: bool = True, device: Any = None) -> None:
        self.cfg = config if config is not None else ServeConfig.from_env()
        self.name = name or f"worker-{uuid.uuid4().hex[:6]}"
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._registry = RegistryClient(registry_url, timeout=self.cfg.timeout_s)
        self._lock = threading.Lock()
        self._flat: Optional[torch.Tensor] = None
        self._version: Optional[Version] = None
        self._chain: Optional[str] = None
        self._latest_seen: Optional[Version] = None
        # k4_launches: the dequantize kernels its delta decodes launched
        self.counters: Dict[str, int] = {"requests_total": 0, "full_pulls_total": 0,
                                         "delta_pulls_total": 0, "full_bytes_total": 0,
                                         "delta_bytes_total": 0, "pull_failovers_total": 0,
                                         "pull_errors_total": 0, "k4_launches": 0}
        self.full_pull_s: List[float] = []
        self.delta_pull_s: List[float] = []
        self._metrics = MetricsRegistry()
        self._stop = threading.Event()
        worker = self

        class _Handler(_QuietHandler):
            _label = "serve_worker"

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                try:
                    raw_path, _, raw_query = self.path.partition("?")
                    if raw_path == "/infer":
                        q = urllib.parse.parse_qs(raw_query)
                        _send_json(self, 200, worker.answer(int(q.get("seed", ["0"])[0])))
                    elif raw_path == "/status":
                        _send_json(self, 200, worker.status())
                    elif raw_path in ("/metrics", "/"):
                        worker._refresh_metrics()
                        _send_metrics(self, worker._metrics)
                    else:
                        self.send_error(404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    # the request plane answers rather than errors: a minimal
                    # degraded body if even answer() raised
                    logger.exception("serve_worker request failed")
                    try:
                        _send_json(self, 200, {"result": None, "error": str(e)})
                    except Exception:  # noqa: BLE001
                        pass

        self._server, self._serve_thread = _start_server("127.0.0.1", self.cfg.port, _Handler,
                                                         f"torchft_serve_{self.name}")
        self._pull_thread = threading.Thread(target=self._pull_loop, daemon=True,
                                             name=f"torchft_pull_{self.name}")
        if start:
            self._pull_thread.start()

    def _on_stream(self) -> Any:
        return _stream_ctx(self._stream)

    # -- request path ------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def version(self) -> Optional[Version]:
        with self._lock:
            return self._version

    def params_flat(self) -> Optional[torch.Tensor]:
        """A copy of the applied flat on the worker's device."""
        with self._lock:
            if self._flat is None:
                return None
            with self._on_stream():
                out = self._flat.clone()
            if self._stream is not None:
                self._stream.synchronize()
            return out

    def answer(self, seed: int) -> Dict[str, Any]:
        with self._lock:
            self.counters["requests_total"] += 1
            with self._on_stream():
                result = answer_from_flat(self._flat, seed)
            version = self._version
        return {"result": result, "version": list(version) if version else None,
                "worker": self.name}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"worker": self.name,
                    "version": list(self._version) if self._version else None,
                    "latest_seen": list(self._latest_seen) if self._latest_seen else None,
                    "chain": self._chain, "lag_steps": self._lag_locked(),
                    "counters": dict(self.counters)}

    def wait_version(self, version: Version, timeout: float = 10.0) -> bool:
        """Block until the worker has applied ``version`` or newer."""
        deadline = time.monotonic() + timeout
        target = tuple(version)
        while time.monotonic() < deadline:
            v = self.version
            if v is not None and tuple(v) >= target:
                return True
            time.sleep(0.01)
        return False

    def _lag_locked(self) -> int:
        if self._latest_seen is None:
            return 0
        if self._version is None:
            return self._latest_seen[1] + 1
        return max(0, self._latest_seen[1] - self._version[1])

    # -- pull plane --------------------------------------------------------
    def _pull_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.pull_once()
            except Exception:  # noqa: BLE001 - keep answering regardless
                with self._lock:
                    self.counters["pull_errors_total"] += 1
                logger.debug("worker pull failed", exc_info=True)

    def pull_once(self) -> bool:
        """One poll and pull; True when a new version was applied (public
        so tests drive the worker deterministically)."""
        _fire_fault("worker_pull", {"worker": self.name})
        listing = self._registry.sources()
        latest = listing.get("latest")
        if latest is None:
            return False
        latest_v: Version = (int(latest[0]), int(latest[1]))
        chain = listing.get("chain")
        with self._lock:
            self._latest_seen = latest_v
            current = self._version
            cur_chain = self._chain
        if current is not None and current >= latest_v and cur_chain == chain:
            return False
        sources = [s for s in listing.get("sources", []) if s["chain"] == chain]
        if not sources:
            return False
        need_full = (current is None or cur_chain != chain
                     or (latest_v[1] - current[1]) > self.cfg.max_lag)
        if not need_full and self._delta_walk(sources, current, latest_v, chain):
            return True
        # a chain gap (pruned ring, missed prev): a full pull
        return self._full_pull(sources, latest_v)

    def _full_pull(self, sources: List[Dict[str, Any]], latest_v: Version) -> bool:
        def on_event(kind: str, **fields: Any) -> None:
            if kind == "heal_failover":
                with self._lock:
                    self.counters["pull_failovers_total"] += 1

        t0 = time.perf_counter()
        host, meta = pull_full_snapshot(sources, latest_v, timeout=self.cfg.timeout_s,
                                        on_event=on_event)
        with self._on_stream():
            flat = host.to(self.device, copy=True) if self.device.type == "cpu" \
                else host.to(self.device)
        if self._stream is not None:
            self._stream.synchronize()
        version: Version = (int(meta["quorum_id"]), int(meta["step"]))
        with self._lock:
            self._flat = flat
            self._version = version
            self._chain = meta["chain"]
            self.counters["full_pulls_total"] += 1
            self.counters["full_bytes_total"] += int(meta["_bytes"])
            self.full_pull_s.append(time.perf_counter() - t0)
        logger.info("%s full-pulled snapshot %s (%d bytes)", self.name, version,
                    int(meta["_bytes"]))
        return True

    def _delta_walk(self, sources: List[Dict[str, Any]], current: Version, latest_v: Version,
                    chain: str) -> bool:
        """Apply the deltas current -> latest, failing over across sources
        per fetch. Deltas chain by ``prev`` (the previously published
        version, which may skip steps)."""
        applied_any = False
        for _ in range(4 * self.cfg.max_lag + 8):
            with self._lock:
                cur = self._version
            if cur is None or cur >= latest_v:
                return applied_any
            t0 = time.perf_counter()
            record = self._fetch_next_delta(sources, cur, chain)
            if record is None:
                return False  # a gap: the caller full-pulls
            with self._on_stream():
                prepared = _prepare_delta(record["wire"], record["mode"], record["n"],
                                          self.device)
            version: Version = (int(record["quorum_id"]), int(record["step"]))
            with self._lock:
                if self._version is None or tuple(record["prev"]) != self._version:
                    return False  # raced: a full pull restarts
                with self._on_stream():
                    launches = _add_delta_(self._flat, prepared, record["n"])
                self._version = version
                self.counters["delta_pulls_total"] += 1
                self.counters["delta_bytes_total"] += record["_bytes"]
                self.counters["k4_launches"] += launches
            del prepared
            if self._stream is not None:
                self._stream.synchronize()
            with self._lock:
                self.delta_pull_s.append(time.perf_counter() - t0)
            applied_any = True
        return applied_any  # a malformed manifest chain: give up this round

    def _fetch_next_delta(self, sources: List[Dict[str, Any]], current: Version,
                          chain: str) -> Optional[Dict[str, Any]]:
        """The delta record whose ``prev`` is ``current``, trying each source
        in registry order (failover per fetch); None when no source has it."""
        last_exc: Optional[Exception] = None
        for src in sources:
            base = src["delta_url"]
            try:
                with urllib.request.urlopen(f"{base}/serve/manifest",
                                            timeout=self.cfg.timeout_s) as r:
                    manifest = json.loads(r.read().decode())
                if manifest.get("chain") != chain:
                    continue
                # the ring is ordered oldest to newest: only the first
                # version past ours can extend it
                for v in (tuple(v) for v in manifest.get("deltas", [])):
                    if v > tuple(current):
                        with urllib.request.urlopen(f"{base}/serve/delta/{v[0]}/{v[1]}",
                                                    timeout=self.cfg.timeout_s) as r:
                            blob = _read_body(r)
                        record = load_record(blob)
                        if (record.get("chain") == chain and record.get("prev") is not None
                                and tuple(record["prev"]) == tuple(current)):
                            record["_bytes"] = blob.nbytes
                            return record
                        break
            except Exception as e:  # noqa: BLE001 - the next source
                last_exc = e
                with self._lock:
                    self.counters["pull_failovers_total"] += 1
        if last_exc is not None:
            logger.debug("delta fetch exhausted sources: %r", last_exc)
        return None

    def _refresh_metrics(self) -> None:
        with self._lock:
            version = self._version
            lag = self._lag_locked()
            counters = dict(self.counters)
        m = self._metrics
        m.gauge_set("serve_version", float(version[1]) if version else -1.0,
                    "Step of the last-applied snapshot.")
        m.gauge_set("serve_lag_steps", float(lag),
                    "Steps between the newest announced snapshot and the applied one.")
        m.counter_set("serve_requests_total", float(counters["requests_total"]),
                      "Inference requests answered.")
        for name in ("full_pulls_total", "delta_pulls_total", "full_bytes_total",
                     "delta_bytes_total", "pull_failovers_total", "pull_errors_total"):
            m.counter_set(f"serve_{name}", float(counters[name]))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if not self._pull_thread.is_alive():
            self._pull_thread.start()

    def shutdown(self) -> None:
        """Stop serving and pulling; the pull thread is joined and the flat
        dropped."""
        self._stop.set()
        _stop_server(self._server, self._serve_thread)
        if self._pull_thread.is_alive() and self._pull_thread is not threading.current_thread():
            self._pull_thread.join(timeout=self.cfg.timeout_s + 5.0)
        with self._lock:
            self._flat = None
        if self._stream is not None:
            self._stream.synchronize()


# --------------------------------------------------------------------------
# CLI: python -m torchft_tpu_torch.serving {worker|registry} ...
# --------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.serving",
                                     description="the serving plane's worker and registry")
    sub = parser.add_subparsers(dest="role", required=True)
    w = sub.add_parser("worker", help="run one inference worker")
    w.add_argument("--registry", default=None,
                   help=f"registry URL (default: ${SERVE_REGISTRY_ENV})")
    w.add_argument("--port", type=int, default=None, help="worker HTTP port")
    w.add_argument("--name", default=None)
    w.add_argument("--device", default=None, help="default: cuda")
    r = sub.add_parser("registry", help="run a standalone snapshot registry")
    r.add_argument("--lighthouse", default=None, help="lighthouse host:port")
    r.add_argument("--port", type=int, default=0)
    r.add_argument("--drain-on", default=None, choices=_DRAIN_POLICIES)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.role == "worker":
        cfg = ServeConfig.from_env(registry=args.registry, port=args.port)
        if not cfg.registry:
            parser.error(f"--registry or ${SERVE_REGISTRY_ENV} is required for a worker")
        worker = ServeWorker(cfg.registry, config=cfg, name=args.name, device=args.device)
        print(json.dumps({"worker": worker.name, "url": worker.url}), flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            worker.shutdown()
        return 0

    cfg = ServeConfig.from_env(drain_on=args.drain_on)
    registry = SnapshotRegistry(lighthouse_addr=args.lighthouse, drain_on=cfg.drain_on,
                                port=args.port)
    print(json.dumps({"registry": registry.url, "epoch": registry.epoch}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        registry.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
