"""Redundancy plane: erasure-coded shard staging, parallel reconstruct on
heal, and hot spares promoted by a shard directory.

Counterpart of ``torchft_tpu/redundancy.py``. A heal without it is one
serial pull of the whole state from one peer. With it, the work moves to
steady state: at the start of the round after each commit, a group leader
(``ShardStager``) snapshots its committed state into one blob
(``pack_state_blob``), erasure-codes it into ``k`` data + ``m`` parity
shards (``checkpointing/erasure.py``, on a background worker) and stages
them on its peers' in-memory ``ShardStore``s, then announces the shard map
to a ``ShardDirectory`` (co-hosted by the lighthouse) with the ``(epoch,
seq)`` stale-rejection handshake. A rejoiner pulls the shards of the
generation its quorum committed in parallel from their holders and decodes
from any ``k`` (``reconstruct_state``; a dead or corrupt holder costs only
the parity arithmetic); a failure falls back to the peer pull. A hot spare
(``HotSpare``, ``Manager(spare=True)``, ``python -m
torchft_tpu_torch.redundancy --hot-spare``) prefetches every announced
generation; when the directory finds a member dead (an ``excluded``
replica in the lighthouse's health ledger, an announce gap, or an
explicit ``mark_dead``), it promotes the spare, which loads its resident
generation and joins the next quorum.

Placement is pod-aware (``TORCHFT_POD``, else the aggregator address
``TORCHFT_LIGHTHOUSE_AGGREGATOR``): data shards on peers in the owner's
pod, parity across pods. ``k == 0`` (the default) turns the plane off: no
store, no directory traffic, and the heal path is the classic pull.

Env: ``TORCHFT_REDUNDANCY_K`` / ``_M`` / ``_DIRECTORY`` / ``_INTERVAL`` /
``_TIMEOUT_S`` / ``_RETAIN`` and ``TORCHFT_POD``.

Where the port differs from the reference, it is in what a replica's
restart and a death leave in the directory, in memory and in teardown,
not in what goes over a wire. A Manager's id is ``<group>:<incarnation>``;
when a group's new incarnation registers, the directory retires the old
one (its store died with it): it leaves the peers that placement reads
and the generations a reconstruct or a spare picks from, its announces
are refused, and it is no death (nothing is promoted). The peers that
placement reads leave out the dead too, and ``reconstruct_state`` counts
a shard held by a retired incarnation as failed without dialling it. A
step-targeted ``reconstruct_state`` raises when no live owner announced
that step, before it fetches or lands anything (the reference returns the
newest generation and leaves the check to its caller, after the landing).
``pack_state_blob`` writes each
leaf straight into one preallocated buffer (the reference copies every
leaf to the host, then joins the copies into a second buffer: two copies
of the state); ``encode_shards`` returns views (``erasure.py``);
``reconstruct_state`` repairs a missing data shard in its place in the
blob; ``unpack_state_blob`` and ``reconstruct_state`` take a ``template``
whose tensors the leaves land in, in place (on the card: one
host-to-device copy each, no second copy of the state on the device);
``ShardStager.stage`` drops a stale pending generation before it
snapshots the next. Every thread the plane starts (store and directory
servers, the directory's tick, the stager's worker, the spare's shadow
loop) is joined by its ``shutdown``, and a stopped store or stager drops
the shards and blobs it held. ``HotSpare(serve_registry=URL)`` also
shadows the serving plane's delta chain with a ``ServeWorker`` whose flat
stays on the host (``status()["serve_version"]``), joined by its
``shutdown``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import pickle
import queue
import re
import struct
import threading
import time
import urllib.error
import urllib.request
import uuid
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch import knobs
from torchft_tpu_torch.checkpointing._serialization import (
    describe_state,
    place_state_like,
    unflatten_state,
)
from torchft_tpu_torch.checkpointing.erasure import (
    encode_shards,
    missing_data_rows,
    shard_crc,
    shard_length,
)
from torchft_tpu_torch.observability import MetricsRegistry
from torchft_tpu_torch.retry import RetryPolicy, retry_call

logger = logging.getLogger(__name__)

__all__ = [
    "DirectoryClient",
    "HotSpare",
    "RedundancyConfig",
    "ShardDirectory",
    "ShardStager",
    "ShardStore",
    "get_shard",
    "get_shard_into",
    "pack_state_blob",
    "plan_placement",
    "pod_identity",
    "put_shard",
    "reconstruct_state",
    "set_redundancy_fault_hook",
    "unpack_state_blob",
]

# ---------------------------------------------------------------- env
REDUNDANCY_K_ENV = "TORCHFT_REDUNDANCY_K"
REDUNDANCY_M_ENV = "TORCHFT_REDUNDANCY_M"
REDUNDANCY_DIRECTORY_ENV = "TORCHFT_REDUNDANCY_DIRECTORY"
REDUNDANCY_INTERVAL_ENV = "TORCHFT_REDUNDANCY_INTERVAL"
REDUNDANCY_TIMEOUT_S_ENV = "TORCHFT_REDUNDANCY_TIMEOUT_S"
REDUNDANCY_RETAIN_ENV = "TORCHFT_REDUNDANCY_RETAIN"
POD_ENV = "TORCHFT_POD"
_AGGREGATOR_ENV = "TORCHFT_LIGHTHOUSE_AGGREGATOR"


def pod_identity(default: str = "pod0") -> str:
    """The replica's placement pod: ``TORCHFT_POD`` when set, else one
    derived from the aggregator it beats through, else ``default`` (a flat
    fleet is one pod)."""
    pod = knobs.env_raw(POD_ENV, "").strip()
    if pod:
        return pod
    agg = knobs.env_raw(_AGGREGATOR_ENV, "").strip()
    if agg:
        return "pod-" + re.sub(r"[^A-Za-z0-9_.-]", "-", agg)
    return default


@dataclass
class RedundancyConfig:
    """The plane's knobs (each overridable by ``TORCHFT_REDUNDANCY_*``).
    ``k == 0`` turns the plane off."""

    k: int = 0  # data shards; 0 = off
    m: int = 1  # parity shards
    directory: str = ""  # ShardDirectory base URL ("" = off)
    interval: int = 1  # stage every N commits
    timeout_s: float = 15.0  # per shard-RPC deadline
    retain: int = 2  # shard generations kept per owner in each store
    pod: str = ""  # placement pod ("" = pod_identity())

    @classmethod
    def from_env(
        cls, base: Optional["RedundancyConfig"] = None, **overrides: Any
    ) -> "RedundancyConfig":
        """The config from the environment; a keyword given and not None
        wins over its variable, and a variable set wins over ``base``'s
        field (``base`` None: the defaults)."""

        def _pick(env: str, key: str, cast: Callable[[str], Any]) -> Any:
            if overrides.get(key) is not None:
                return overrides[key]
            raw = knobs.env_raw(env)
            if raw is None or not raw.strip():
                return getattr(base if base is not None else cls, key)
            try:
                return cast(raw.strip())
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad {env}={raw!r}: {e}") from e

        cfg = cls(
            k=_pick(REDUNDANCY_K_ENV, "k", int),
            m=_pick(REDUNDANCY_M_ENV, "m", int),
            directory=_pick(REDUNDANCY_DIRECTORY_ENV, "directory", str),
            interval=_pick(REDUNDANCY_INTERVAL_ENV, "interval", int),
            timeout_s=_pick(REDUNDANCY_TIMEOUT_S_ENV, "timeout_s", float),
            retain=_pick(REDUNDANCY_RETAIN_ENV, "retain", int),
            pod=_pick(POD_ENV, "pod", str),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.k < 0:
            raise ValueError(f"invalid {REDUNDANCY_K_ENV}={self.k}: must be >= 0")
        if self.k:
            if self.m < 1:
                raise ValueError(
                    f"invalid {REDUNDANCY_M_ENV}={self.m}: need >= 1 parity shard "
                    "when redundancy is on (k > 0)"
                )
            if self.k + self.m > 255:
                raise ValueError(f"k+m={self.k + self.m} exceeds the GF(256) shard limit")
        if self.interval < 1:
            raise ValueError(f"invalid {REDUNDANCY_INTERVAL_ENV}={self.interval}: must be >= 1")
        if self.timeout_s <= 0:
            raise ValueError(f"invalid {REDUNDANCY_TIMEOUT_S_ENV}={self.timeout_s}: must be > 0")
        if self.retain < 1:
            raise ValueError(f"invalid {REDUNDANCY_RETAIN_ENV}={self.retain}: must be >= 1")

    @property
    def enabled(self) -> bool:
        return self.k >= 1 and bool(self.directory)

    def to_json(self) -> Dict[str, Any]:
        return {
            "k": self.k,
            "m": self.m,
            "directory": self.directory,
            "interval": self.interval,
            "timeout_s": self.timeout_s,
            "retain": self.retain,
            "pod": self.pod,
        }


# ---------------------------------------------------------------- fault hook
_fault_hook: Optional[Callable[[str, Dict[str, Any]], Optional[str]]] = None
_fault_lock = threading.Lock()


def set_redundancy_fault_hook(
    fn: Optional[Callable[[str, Dict[str, Any]], Optional[str]]],
) -> None:
    """Install a process-wide fault hook (tests and fault scripts; None
    removes it). ``fn(event, info)`` runs at ``"shard_get"`` (a store is
    about to serve a shard body; info: owner, step, idx, holder) and
    ``"shard_put"`` (a store is about to take one). ``"corrupt"`` flips one
    byte of the served body (the announced crc32 then flags it);
    ``"die"`` drops the connection mid-body (a GET serves half of it)."""
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
    except Exception:  # noqa: BLE001 - a broken hook must not break the plane
        logger.exception("redundancy fault hook failed on %s", event)
        return None


# ---------------------------------------------------------------- state blob
_BLOB_HEADER = struct.Struct("<q")  # pickled-spec length


def pack_state_blob(state: Any) -> np.ndarray:
    """A committed state pytree as one contiguous erasure input, the
    reference's layout: ``<spec_len><pickled TreeSpecPayload><leaf
    bytes...>``, each tensor leaf its raw bytes (the HTTP transport's
    canonical bytes), so the round trip is bitwise. A uint8 array, written
    in place: one device-to-host copy per CUDA leaf, one copy per CPU
    leaf, and no second buffer."""
    spec, leaves = describe_state(state)
    spec_bytes = pickle.dumps(spec)
    head = _BLOB_HEADER.size + len(spec_bytes)
    blob = np.empty(head + sum(meta.nbytes for meta in spec.leaves), dtype=np.uint8)
    _BLOB_HEADER.pack_into(blob, 0, len(spec_bytes))
    blob[_BLOB_HEADER.size:head] = np.frombuffer(spec_bytes, dtype=np.uint8)
    off = head
    for meta, leaf in zip(spec.leaves, leaves):
        dst = blob[off:off + meta.nbytes]
        off += meta.nbytes
        if meta.kind == "pickled":
            dst[:] = np.frombuffer(leaf, dtype=np.uint8)
        elif meta.nbytes:
            # a pageable copy: synchronous with the device, a snapshot the
            # next step cannot tear
            torch.from_numpy(dst).view(leaf.dtype).view(leaf.shape).copy_(leaf)
    return blob


def unpack_state_blob(blob: Any, template: Optional[Any] = None) -> Any:
    """The state pytree of a blob. Tensor leaves are CPU tensors over the
    blob's own memory (no copy; a read-only blob gives read-only leaves);
    with ``template`` (a pytree of the same structure, such as
    ``Manager.state_dict_template()``) they land in its tensors in place
    and the template's tensors are returned."""
    view = memoryview(blob).cast("B")
    (spec_len,) = _BLOB_HEADER.unpack_from(view, 0)
    off = _BLOB_HEADER.size
    spec = pickle.loads(view[off:off + spec_len])
    off += spec_len
    payloads: List[Any] = []
    for meta in spec.leaves:
        chunk = view[off:off + meta.nbytes]
        off += meta.nbytes
        payloads.append(bytes(chunk) if meta.kind == "pickled" else chunk)
    state = unflatten_state(spec, payloads)
    if template is not None:
        state = place_state_like(state, template, logger)
    return state


# ---------------------------------------------------------------- HTTP plumbing
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


def _http_json(
    url: str, payload: Optional[Dict[str, Any]] = None, timeout: float = 5.0
) -> Tuple[int, Dict[str, Any]]:
    """One JSON request: (status, body). A 4xx body is parsed, not raised:
    the directory answers with structured 409s."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method="POST" if data is not None else "GET",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except Exception:  # noqa: BLE001
            return e.code, {}


class _Serving:
    """A ThreadingHTTPServer on its own thread; ``stop`` shuts it down and
    joins the thread."""

    def __init__(self, handler: type, host: str, port: int, name: str) -> None:
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True, name=name)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 - teardown must not raise
            pass
        self._thread.join()


# ---------------------------------------------------------------- ShardStore
class ShardStore:
    """In-memory peer shard depot with a ranged, resumable GET.

    Bodies are raw shard bytes; their integrity rides the directory's
    announced crc32, so a byte flipped anywhere between encode and decode
    is caught by the puller. ``?offset=N`` resumes a torn pull.
    ``throttle_mb_s`` rate-limits each GET body (a stand-in for a peer
    NIC's egress on loopback). Nothing touches the disk."""

    def __init__(
        self,
        replica_id: str,
        host: str = "127.0.0.1",
        port: int = 0,
        retain: int = 2,
        throttle_mb_s: Optional[float] = None,
    ) -> None:
        self.replica_id = replica_id
        self._retain = max(1, int(retain))
        self._throttle_mb_s = throttle_mb_s
        self._lock = threading.Lock()
        # (owner, step) -> {idx: body}
        self._shards: Dict[Tuple[str, int], Dict[int, Any]] = {}
        self._counters: Dict[str, int] = {"puts_total": 0, "gets_total": 0, "bytes_stored": 0}
        store = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("shard_store: " + fmt, *args)

            def do_PUT(self) -> None:  # noqa: N802 - http.server API
                try:
                    parsed = store._parse_path(self.path)
                    if parsed is None:
                        self.send_error(404)
                        return
                    owner, step, idx = parsed
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    body = self.rfile.read(length)
                    verdict = _fire_fault("shard_put", {
                        "owner": owner, "step": step, "idx": idx, "holder": store.replica_id})
                    if verdict == "die":
                        self.connection.close()
                        return
                    store.put(owner, step, idx, body)
                    _send_json(self, 200, {"ok": True, "crc": shard_crc(body)})
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("shard_store PUT failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

            do_POST = do_PUT  # noqa: N815 - the same staging contract

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                try:
                    path, _, query = self.path.partition("?")
                    if path == "/redundancy/store/status":
                        _send_json(self, 200, store.status())
                        return
                    parsed = store._parse_path(path)
                    if parsed is None:
                        self.send_error(404)
                        return
                    owner, step, idx = parsed
                    body = store.get(owner, step, idx)
                    if body is None:
                        self.send_error(404, "no such shard")
                        return
                    offset = 0
                    for part in query.split("&"):
                        if part.startswith("offset="):
                            offset = max(0, int(part[7:]))
                    verdict = _fire_fault("shard_get", {
                        "owner": owner, "step": step, "idx": idx, "holder": store.replica_id})
                    if verdict == "corrupt":
                        flipped = bytearray(body)
                        flipped[len(flipped) // 2] ^= 0x01
                        body = bytes(flipped)
                    body = memoryview(body).cast("B")[offset:]
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    if verdict == "die":
                        # half the body, then the socket drops: the puller
                        # resumes from its last byte or fails over to parity
                        self.wfile.write(body[:max(1, len(body) // 2)])
                        self.wfile.flush()
                        self.connection.close()
                        return
                    store._write_throttled(self.wfile, body)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("shard_store GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

        self._serving = _Serving(_Handler, host, port, f"torchft_shard_store_{replica_id}")

    @property
    def url(self) -> str:
        return self._serving.url

    @staticmethod
    def _parse_path(path: str) -> Optional[Tuple[str, int, int]]:
        m = re.fullmatch(r"/redundancy/shard/([^/]+)/(\d+)/(\d+)", path)
        if not m:
            return None
        return m.group(1), int(m.group(2)), int(m.group(3))

    def _write_throttled(self, wfile: Any, body: memoryview) -> None:
        if not self._throttle_mb_s:
            wfile.write(body)
            return
        budget = self._throttle_mb_s * 1024 * 1024
        slice_n = max(64 * 1024, int(budget * 0.05))  # ~50 ms slices
        off = 0
        start = time.monotonic()
        while off < len(body):
            wfile.write(body[off:off + slice_n])
            off += slice_n
            # paced from the total elapsed, so an overshoot corrects itself
            ahead = off / budget - (time.monotonic() - start)
            if ahead > 0:
                time.sleep(ahead)

    # -- storage ---------------------------------------------------------
    def put(self, owner: str, step: int, idx: int, body: Any) -> None:
        with self._lock:
            self._shards.setdefault((owner, step), {})[idx] = body
            self._counters["puts_total"] += 1
            steps = sorted(s for (o, s) in self._shards if o == owner)
            for stale in steps[:-self._retain]:
                self._shards.pop((owner, stale), None)
            self._counters["bytes_stored"] = sum(
                len(b) for gen in self._shards.values() for b in gen.values()
            )

    def get(self, owner: str, step: int, idx: int) -> Optional[Any]:
        with self._lock:
            self._counters["gets_total"] += 1
            return self._shards.get((owner, step), {}).get(idx)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "generations": [
                    {"owner": o, "step": s, "shards": sorted(g)}
                    for (o, s), g in sorted(self._shards.items())
                ],
                "counters": dict(self._counters),
            }

    def shutdown(self) -> None:
        """Stop serving (the server thread joined) and drop every shard."""
        self._serving.stop()
        with self._lock:
            self._shards.clear()
            self._counters["bytes_stored"] = 0


def put_shard(
    store_url: str, owner: str, step: int, idx: int, body: Any, timeout: float,
    crc: Optional[int] = None,
) -> None:
    """PUT one shard; the store's crc32 of what it received must be the
    body's (``crc``, when the caller has it already)."""
    req = urllib.request.Request(
        f"{store_url}/redundancy/shard/{owner}/{step}/{idx}", data=body, method="PUT",
        headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        resp = json.loads(r.read().decode() or "{}")
    if resp.get("crc") != (shard_crc(body) if crc is None else crc):
        raise IOError(f"shard {owner}/{step}/{idx} corrupted in flight to {store_url}")


def get_shard_into(
    dest: Any, store_url: str, owner: str, step: int, idx: int,
    nbytes: int, expect_crc: int, timeout: float, max_resumes: int = 3,
) -> None:
    """Pull one shard straight into a writable buffer (the parallel
    reconstruct's scatter-gather: a data shard lands at its offset in the
    blob). The crc32 runs with the transfer, one update a chunk; a torn
    body resumes from its last byte (``?offset=N``), at most
    ``max_resumes`` times."""
    view = memoryview(dest).cast("B")
    if view.nbytes < nbytes:
        raise ValueError(f"shard buffer holds {view.nbytes} bytes, shard is {nbytes}")
    got = 0
    crc = 0
    resumes = 0
    while True:
        url = f"{store_url}/redundancy/shard/{owner}/{step}/{idx}"
        if got:
            url += f"?offset={got}"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                while got < nbytes:
                    n = r.readinto(view[got:got + min(4 << 20, nbytes - got)])
                    if not n:
                        break
                    crc = zlib.crc32(view[got:got + n], crc)
                    got += n
        except (urllib.error.URLError, ConnectionError, IOError, http.client.HTTPException):
            if got >= nbytes or resumes >= max_resumes:
                raise
            resumes += 1
            continue
        if got < nbytes and resumes < max_resumes:
            resumes += 1
            continue
        break
    if got < nbytes:
        raise IOError(
            f"shard {owner}/{step}/{idx} from {store_url} truncated at {got}/{nbytes} bytes"
        )
    if crc & 0xFFFFFFFF != expect_crc:
        raise IOError(f"shard {owner}/{step}/{idx} from {store_url} failed crc32")


def get_shard(
    store_url: str, owner: str, step: int, idx: int, nbytes: int,
    expect_crc: int, timeout: float, max_resumes: int = 3,
) -> bytes:
    """Pull one shard as bytes (``get_shard_into`` lands it in place)."""
    buf = bytearray(nbytes)
    get_shard_into(buf, store_url, owner, step, idx, nbytes, expect_crc,
                   timeout=timeout, max_resumes=max_resumes)
    return bytes(buf)


# ---------------------------------------------------------------- ShardDirectory
class ShardDirectory:
    """Where every replica's shard generations live; promotes hot spares
    when an owner dies.

    Stale-instance protection is the ``(epoch, seq)`` pattern: a fresh
    ``epoch`` at startup, granted at registration; an announce carries it,
    a per-owner monotonic ``seq`` and a strictly increasing ``step``. A
    replayed or delayed announce, or one from before a restart, is
    rejected with a structured 409, never merged.

    An owner is dead for promotion when the lighthouse's health ledger
    lists it ``excluded`` (polled every ``poll_s``), when ``mark_dead``
    says so, or when its newest generation trails the fleet's by
    ``gap_steps`` and it has announced nothing for ``dead_after_s``.
    Promotions are monotonic: each takes the next ``promote_seq``, a spare
    is never un-promoted, a dead owner is never promoted onto twice, and
    only a spare whose health state is ``spare_eligible`` is promoted."""

    def __init__(
        self,
        lighthouse_addr: Optional[str] = None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        poll_s: float = 0.25,
        dead_after_s: float = 2.0,
        gap_steps: int = 2,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self._lock = threading.Lock()
        self.epoch = uuid.uuid4().hex[:12]
        self._poll_s = poll_s
        self._dead_after_s = dead_after_s
        self._gap_steps = max(1, int(gap_steps))
        self._lighthouse_addr = lighthouse_addr
        self._health_fn = health_fn
        # replica_id -> {pod, store_url, spare, registered_at}
        self._peers: Dict[str, Dict[str, Any]] = {}
        self._registered: Dict[str, str] = {}  # replica_id -> epoch granted
        self._entries: Dict[str, Dict[str, Any]] = {}  # owner -> latest announce
        self._health_states: Dict[str, str] = {}
        self._excluded: set = set()
        self._dead: set = set()
        # old incarnations of a group that registered again (see register)
        self._retired: set = set()
        self._promotions: Dict[str, Dict[str, Any]] = {}  # spare_id -> record
        self._promote_seq = 0
        self._replaced: set = set()  # owners already promoted onto
        self._counters: Dict[str, int] = {
            "announce_total": 0,
            "announce_rejected_total": 0,
            "promotions_total": 0,
            "dead_marked_total": 0,
        }
        self._metrics = MetricsRegistry()
        self._stop = threading.Event()
        directory = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("shard_directory: " + fmt, *args)

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                try:
                    path = self.path.partition("?")[0]
                    if path == "/redundancy/directory":
                        _send_json(self, 200, directory.directory())
                    elif path == "/redundancy/peers":
                        _send_json(self, 200, directory.peers())
                    elif path.startswith("/redundancy/spare/"):
                        sid = path[len("/redundancy/spare/"):]
                        _send_json(self, 200, directory.spare_status(sid))
                    elif path == "/redundancy/status":
                        _send_json(self, 200, directory.status())
                    elif path in ("/metrics", "/"):
                        directory._refresh_metrics()
                        body = directory._metrics.render().encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self.send_error(404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("shard_directory GET failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self) -> None:  # noqa: N802 - http.server API
                try:
                    path = self.path.partition("?")[0]
                    body = _json_body(self)
                    if path == "/redundancy/register":
                        code, resp = directory.register(
                            str(body["replica_id"]), str(body.get("pod", "pod0")),
                            str(body.get("store_url", "")), bool(body.get("spare", False)),
                        )
                    elif path == "/redundancy/announce":
                        code, resp = directory.announce(body)
                    elif path == "/redundancy/dead":
                        code, resp = directory.mark_dead(str(body["replica_id"]))
                    else:
                        self.send_error(404)
                        return
                    _send_json(self, code, resp)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("shard_directory POST failed")
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001
                        pass

        self._serving = _Serving(_Handler, host, port, "torchft_shard_directory")
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True, name="torchft_shard_directory_tick"
        )
        self._tick_thread.start()

    # -- public api --------------------------------------------------------
    @property
    def url(self) -> str:
        return self._serving.url

    def register(
        self, replica_id: str, pod: str, store_url: str, spare: bool
    ) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            if not spare:
                # a group's new incarnation retires the old one, whose
                # store died with it: no placement, no reconstruct and no
                # promotion look at it again
                group = _incarnation_group(replica_id)
                for rid in [r for r, p in self._peers.items()
                            if group and r != replica_id and not p["spare"]
                            and _incarnation_group(r) == group]:
                    self._retire_locked(rid)
            self._registered[replica_id] = self.epoch
            self._peers[replica_id] = {
                "pod": pod,
                "store_url": store_url,
                "spare": bool(spare),
                "registered_at": time.time(),
            }
            # a re-registering replica is alive again; a promoted spare
            # keeps its promotion record (monotonicity)
            self._dead.discard(replica_id)
            return 200, {"epoch": self.epoch}

    def announce(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        try:
            owner = str(body["replica_id"])
            epoch = str(body["epoch"])
            seq = int(body["seq"])
            step = int(body["step"])
            k = int(body["k"])
            m = int(body["m"])
            data_len = int(body["data_len"])
            shards = list(body["shards"])
            for s in shards:
                s["idx"] = int(s["idx"])
                s["crc"] = int(s["crc"])
                s["url"] = str(s["url"])
                s["holder"] = str(s.get("holder", ""))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"malformed announce: {e}"}
        with self._lock:
            self._counters["announce_total"] += 1
            if epoch != self.epoch:
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_epoch", "epoch": self.epoch}
            prior = self._entries.get(owner)
            if prior is not None and seq <= prior["seq"]:
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_seq", "have_seq": prior["seq"]}
            if prior is not None and step <= prior["step"]:
                # shard generations are strictly monotone per owner
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_step", "have_step": prior["step"]}
            if owner in self._replaced or owner in self._retired:
                # a dead owner already promoted onto, or an incarnation
                # its group replaced, cannot bring its old shard map back
                # into the fleet
                self._counters["announce_rejected_total"] += 1
                return 409, {"error": "stale_owner"}
            self._entries[owner] = {
                "seq": seq,
                "step": step,
                "k": k,
                "m": m,
                "data_len": data_len,
                "shards": shards,
                "announced_at": time.time(),
            }
            return 200, {"ok": True}

    def mark_dead(self, replica_id: str) -> Tuple[int, Dict[str, Any]]:
        """An explicit death notice (operators, a fault harness): the path
        the health poll and the announce-gap detector feed."""
        with self._lock:
            if replica_id not in self._dead:
                self._dead.add(replica_id)
                self._counters["dead_marked_total"] += 1
        self._maybe_promote()
        with self._lock:
            return 200, {"ok": True, "dead": sorted(self._dead)}

    def directory(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "epoch": self.epoch,
                "entries": {o: dict(e) for o, e in self._entries.items()},
                "latest": self._latest_locked(),
                "peers": self._peers_locked(),
                "dead": sorted(self._dead),
                "retired": sorted(self._retired),
                "promotions": {s: dict(p) for s, p in self._promotions.items()},
            }

    def peers(self) -> Dict[str, Any]:
        with self._lock:
            return {"epoch": self.epoch, "peers": self._peers_locked()}

    def spare_status(self, spare_id: str) -> Dict[str, Any]:
        with self._lock:
            promo = self._promotions.get(spare_id)
            return {
                "epoch": self.epoch,
                "spare_id": spare_id,
                "registered": spare_id in self._registered,
                "promote": promo is not None,
                "promotion": dict(promo) if promo else None,
            }

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "epoch": self.epoch,
                "entries": {o: e["step"] for o, e in self._entries.items()},
                "peers": sorted(self._peers),
                "spares": sorted(r for r, p in self._peers.items() if p["spare"]),
                "dead": sorted(self._dead),
                "promotions": {s: dict(p) for s, p in self._promotions.items()},
                "counters": dict(self._counters),
            }

    def apply_health(self, health: Dict[str, Any]) -> None:
        """Fold one health ledger dump: an ``excluded`` replica is dead for
        promotion; each replica's ``state`` gates which spares may be
        promoted (``healthwatch.spare_eligible``)."""
        replicas = health.get("replicas", {}) or {}
        with self._lock:
            self._health_states = {
                str(rid): str(info.get("state", "ok")) for rid, info in replicas.items()
            }
            newly = set()
            for rid in health.get("excluded", []) or []:
                rid = str(rid)
                self._excluded.add(rid)
                if rid in self._registered and rid not in self._dead:
                    newly.add(rid)
            for rid in newly:
                self._dead.add(rid)
                self._counters["dead_marked_total"] += 1
        if newly:
            self._maybe_promote()

    def shutdown(self) -> None:
        """Stop the tick and the server, and join both threads."""
        self._stop.set()
        self._serving.stop()
        self._tick_thread.join()

    # -- internals ---------------------------------------------------------
    def _peers_locked(self) -> List[Dict[str, Any]]:
        """The live peers (placement's view): the dead left out."""
        return [
            {"replica_id": rid, "pod": p["pod"], "store_url": p["store_url"], "spare": p["spare"]}
            for rid, p in sorted(self._peers.items()) if rid not in self._dead
        ]

    def _retire_locked(self, replica_id: str) -> None:
        self._retired.add(replica_id)
        self._peers.pop(replica_id, None)
        self._registered.pop(replica_id, None)
        self._entries.pop(replica_id, None)
        self._dead.discard(replica_id)
        logger.info("shard_directory: retiring %s (its group registered a new incarnation)",
                    replica_id)

    def _latest_locked(self) -> Optional[List[Any]]:
        live = [
            (e["step"], o) for o, e in self._entries.items()
            if o not in self._dead and o not in self._replaced
        ] or [(e["step"], o) for o, e in self._entries.items()]
        if not live:
            return None
        step, owner = max(live)
        return [owner, step]

    def _tick_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                health = self._poll_health()
                if health is not None:
                    self.apply_health(health)
            except Exception:  # noqa: BLE001 - keep ticking through a failed poll
                logger.debug("shard_directory health poll failed", exc_info=True)
            try:
                self._detect_gaps()
                self._maybe_promote()
            except Exception:  # noqa: BLE001
                logger.exception("shard_directory tick failed")

    def _poll_health(self) -> Optional[Dict[str, Any]]:
        if self._health_fn is not None:
            return self._health_fn()
        if self._lighthouse_addr is None:
            return None
        from torchft_tpu_torch.coordination import LighthouseClient  # lazy: import cycle

        return LighthouseClient(self._lighthouse_addr, connect_timeout=2.0).health()

    def _detect_gaps(self) -> None:
        """An owner whose newest generation trails the fleet's by
        ``gap_steps`` and that has announced nothing for ``dead_after_s``
        is presumed dead: the fleet committed on without it."""
        now = time.time()
        with self._lock:
            if len(self._entries) < 2:
                return
            max_step = max(e["step"] for e in self._entries.values())
            newly = {
                owner for owner, e in self._entries.items()
                if owner not in self._dead and owner not in self._replaced
                and e["step"] <= max_step - self._gap_steps
                and now - e["announced_at"] > self._dead_after_s
            }
            for owner in newly:
                self._dead.add(owner)
                self._counters["dead_marked_total"] += 1
                logger.info(
                    "shard_directory: presuming %s dead (generation %s vs fleet max %s, "
                    "quiet %.1fs)", owner, self._entries[owner]["step"], max_step,
                    now - self._entries[owner]["announced_at"],
                )

    def _maybe_promote(self) -> None:
        from torchft_tpu_torch.healthwatch import spare_eligible

        with self._lock:
            pending = [
                o for o in sorted(self._dead)
                if o not in self._replaced and not self._peers.get(o, {}).get("spare", False)
            ]
            if not pending:
                return
            promoted_spares = set(self._promotions)
            for owner in pending:
                candidate = next((
                    rid for rid, p in sorted(self._peers.items())
                    if p["spare"] and rid not in promoted_spares and rid not in self._dead
                    and spare_eligible(self._health_states.get(rid, "ok"))
                ), None)
                if candidate is None:
                    return
                self._promote_seq += 1
                self._promotions[candidate] = {
                    "promote_seq": self._promote_seq,
                    "replaces": owner,
                    "at": time.time(),
                }
                self._replaced.add(owner)
                promoted_spares.add(candidate)
                self._counters["promotions_total"] += 1
                logger.info("shard_directory: promoting spare %s to replace %s (promote_seq=%d)",
                            candidate, owner, self._promote_seq)

    def _refresh_metrics(self) -> None:
        with self._lock:
            n_entries = len(self._entries)
            n_spares = sum(1 for p in self._peers.values() if p["spare"])
            n_shards = sum(len(e["shards"]) for e in self._entries.values())
            latest = self._latest_locked()
            counters = dict(self._counters)
        m = self._metrics
        m.gauge_set("redundancy_entries", float(n_entries),
                    "Owners with a live shard generation in the directory.")
        m.gauge_set("redundancy_spares", float(n_spares),
                    "Registered hot spares shadowing the fleet.")
        m.gauge_set("redundancy_shards_tracked", float(n_shards),
                    "Total shards across all live generations.")
        m.gauge_set("redundancy_latest_step", float(latest[1]) if latest else -1.0,
                    "Step of the newest announced shard generation.")
        for name, val in counters.items():
            m.counter_set(f"redundancy_{name}", float(val))


class DirectoryClient:
    """A retrying client of the ShardDirectory: transport errors retry
    under the jittered-backoff policy; structured 4xx answers are
    returned, not retried."""

    def __init__(
        self, base_url: str, timeout: float = 5.0, policy: Optional[RetryPolicy] = None
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.policy = policy or RetryPolicy.from_env()

    def _call(
        self, path: str, payload: Optional[Dict[str, Any]] = None
    ) -> Tuple[int, Dict[str, Any]]:
        def attempt(remaining: float) -> Tuple[int, Dict[str, Any]]:
            return _http_json(f"{self.base_url}{path}", payload,
                              timeout=min(self.timeout, max(remaining, 0.05)))

        return retry_call(
            attempt, policy=self.policy, timeout=self.timeout,
            retryable=(OSError, TimeoutError, ConnectionError, ValueError),
        )

    def register(self, replica_id: str, pod: str, store_url: str, spare: bool = False) -> str:
        code, resp = self._call("/redundancy/register", {
            "replica_id": replica_id, "pod": pod, "store_url": store_url, "spare": spare,
        })
        if code != 200:
            raise IOError(f"shard directory register failed: {code} {resp}")
        return str(resp["epoch"])

    def announce(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        return self._call("/redundancy/announce", body)

    def get_directory(self) -> Dict[str, Any]:
        code, resp = self._call("/redundancy/directory")
        if code != 200:
            raise IOError(f"shard directory fetch failed: {code}")
        return resp

    def peers(self) -> List[Dict[str, Any]]:
        code, resp = self._call("/redundancy/peers")
        if code != 200:
            raise IOError(f"shard directory peers failed: {code}")
        return list(resp["peers"])

    def spare_status(self, spare_id: str) -> Dict[str, Any]:
        code, resp = self._call(f"/redundancy/spare/{spare_id}")
        if code != 200:
            raise IOError(f"spare status failed: {code}")
        return resp

    def mark_dead(self, replica_id: str) -> None:
        self._call("/redundancy/dead", {"replica_id": replica_id})


def _incarnation_group(replica_id: str) -> str:
    """The group of a Manager's ``<group>:<incarnation>`` id ("" for an id
    of another form)."""
    group, sep, _ = replica_id.rpartition(":")
    return group if sep else ""


# ---------------------------------------------------------------- placement
def plan_placement(
    peers: List[Dict[str, Any]], own_id: str, own_pod: str, k: int, m: int,
) -> Optional[List[Dict[str, Any]]]:
    """A holder peer for each of the ``k + m`` shards.

    Data shards prefer peers in the owner's pod (the common reconstruct is
    a pod-local parallel pull), parity shards peers in other pods (a lost
    pod still leaves parity elsewhere). Neither the owner nor a spare ever
    holds a shard (the point is surviving the owner's death; a spare stays
    payload-free so its promotion is instant). Fewer holders than shards
    wrap round-robin; no eligible holder gives None."""
    eligible = [
        p for p in peers
        if p["replica_id"] != own_id and not p.get("spare", False) and p.get("store_url")
    ]
    if not eligible:
        return None
    in_pod = [p for p in eligible if p.get("pod") == own_pod]
    out_pod = [p for p in eligible if p.get("pod") != own_pod]
    data_pref = (in_pod + out_pod) or eligible
    parity_pref = (out_pod + in_pod) or eligible
    return ([data_pref[i % len(data_pref)] for i in range(k)]
            + [parity_pref[j % len(parity_pref)] for j in range(m)])


# ---------------------------------------------------------------- ShardStager
class ShardStager:
    """One group leader's staging engine.

    The hot path pays ``pack_state_blob`` (one snapshot copy of the
    committed leaves) and a queue put; the erasure encode, the peer PUTs
    and the announce run on a background worker. Only the newest pending
    generation is kept: a slow fleet drops intermediate generations
    rather than fall behind (the directory's strict step monotonicity
    makes the skip safe)."""

    def __init__(
        self,
        cfg: RedundancyConfig,
        replica_id: str,
        on_metric: Optional[Callable[[str, float], None]] = None,
        store: Optional[ShardStore] = None,
    ) -> None:
        if not cfg.enabled:
            raise ValueError("ShardStager requires an enabled RedundancyConfig")
        self.cfg = cfg
        self.replica_id = replica_id
        self.pod = cfg.pod or pod_identity()
        self._on_metric = on_metric or (lambda name, value: None)
        self.store = store or ShardStore(replica_id, retain=cfg.retain)
        self._client = DirectoryClient(cfg.directory, timeout=cfg.timeout_s)
        self._epoch: Optional[str] = None
        self._seq = 0
        self._commits_seen = 0
        self._pending: "queue.Queue[Optional[Tuple[int, Any]]]" = queue.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._last_staged_step = -1
        self._wrap_warned = False
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._worker_loop, daemon=True, name=f"torchft_shard_stager_{replica_id}"
        )
        self._worker.start()
        self.register()

    def register(self) -> None:
        try:
            self._epoch = self._client.register(self.replica_id, self.pod, self.store.url,
                                                spare=False)
        except Exception:  # noqa: BLE001 - the directory may come up later
            logger.warning("shard stager %s could not register with directory %s yet",
                           self.replica_id, self.cfg.directory)
            self._epoch = None

    # -- hot path ----------------------------------------------------------
    def stage(self, step: int, state: Any) -> bool:
        """Snapshot and enqueue one committed generation (the hot path).
        False when the interval skips it."""
        self._commits_seen += 1
        if (self._commits_seen - 1) % self.cfg.interval != 0:
            self._on_metric("shard_stage_skipped", 1)
            return False
        # newest wins: the stale pending generation goes before the new
        # snapshot is taken, so two never sit on the host at once
        self._drop_pending()
        t0 = time.monotonic()
        blob = pack_state_blob(state)
        self._on_metric("shard_stage_snapshot_s", time.monotonic() - t0)
        self._pending.put((int(step), blob))
        return True

    def _drop_pending(self) -> None:
        try:
            while True:
                if self._pending.get_nowait() is not None:
                    self._on_metric("shard_stage_dropped", 1)
        except queue.Empty:
            pass

    # -- worker ------------------------------------------------------------
    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._pending.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            step, blob = item
            del item
            try:
                self._stage_one(step, blob)
            except Exception:  # noqa: BLE001 - staging is advisory
                logger.exception("shard staging failed for step %s (advisory)", step)
                self._on_metric("shard_stage_failed", 1)
            del blob

    def _stage_one(self, step: int, blob: Any) -> None:
        cfg = self.cfg
        t0 = time.monotonic()
        if self._epoch is None:
            self.register()
            if self._epoch is None:
                self._on_metric("shard_stage_failed", 1)
                return
        peers = self._client.peers()
        plan = plan_placement(peers, self.replica_id, self.pod, cfg.k, cfg.m)
        if plan is None:
            logger.info("no eligible shard holders yet for %s step %s: staging skipped",
                        self.replica_id, step)
            self._on_metric("shard_stage_failed", 1)
            return
        holders = {p["replica_id"] for p in plan}
        if len(holders) < cfg.k + cfg.m and not self._wrap_warned:
            self._wrap_warned = True
            logger.warning("only %d distinct shard holders for k+m=%d: placement wraps; "
                           "distinct-peer durability degraded until the fleet grows",
                           len(holders), cfg.k + cfg.m)
        t_enc = time.monotonic()
        shards = encode_shards(blob, cfg.k, cfg.m)
        self._on_metric("shard_encode_s", time.monotonic() - t_enc)
        # per-shard holder failover: a dead peer must not sink the whole
        # generation (staging matters most right after a member died). A
        # shard tries its planned holder, then every other distinct live
        # one; the generation is announced if any k shards landed
        t_put = time.monotonic()
        distinct = list({p["replica_id"]: p for p in plan}.values())
        down: set = set()
        entries = []
        for idx, (body, peer) in enumerate(zip(shards, plan)):
            placed = None
            crc = shard_crc(body)
            for cand in [peer] + [p for p in distinct if p["replica_id"] != peer["replica_id"]]:
                if cand["replica_id"] in down:
                    continue
                try:
                    put_shard(cand["store_url"], self.replica_id, step, idx, body,
                              timeout=cfg.timeout_s, crc=crc)
                    placed = cand
                    break
                except Exception:  # noqa: BLE001 - the next holder
                    down.add(cand["replica_id"])
                    self._on_metric("shard_put_failed", 1)
            if placed is not None:
                entries.append({"idx": idx, "holder": placed["replica_id"],
                                "url": placed["store_url"], "crc": crc})
        self._on_metric("shard_put_s", time.monotonic() - t_put)
        del shards
        if len(entries) < cfg.k:
            logger.warning("only %d/%d shards placed for step %s (< k=%d): generation dropped",
                           len(entries), cfg.k + cfg.m, step, cfg.k)
            self._on_metric("shard_stage_failed", 1)
            return
        self._seq += 1
        body = {
            "replica_id": self.replica_id,
            "epoch": self._epoch,
            "seq": self._seq,
            "step": step,
            "k": cfg.k,
            "m": cfg.m,
            "data_len": len(blob),
            "shards": entries,
        }
        code, resp = self._client.announce(body)
        if code == 409 and resp.get("error") == "stale_epoch":
            # the directory restarted: register again and replay once
            self.register()
            if self._epoch is not None:
                body["epoch"] = self._epoch
                code, resp = self._client.announce(body)
        if code != 200:
            logger.warning("shard announce rejected for step %s: %s", step, resp)
            self._on_metric("shard_announce_rejected", 1)
            return
        with self._lock:
            self._last_staged_step = step
        self._on_metric("shards_staged", len(entries))
        self._on_metric("shard_stage_bytes", float(len(blob)))
        self._on_metric("shard_stage_s", time.monotonic() - t0)

    # -- introspection / teardown -----------------------------------------
    def last_staged_step(self) -> int:
        with self._lock:
            return self._last_staged_step

    def wait_staged(self, step: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.last_staged_step() >= step:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        """Stop the worker (a generation in flight finishes its PUTs, each
        bounded by ``timeout_s``), join it, drop a pending blob and stop
        the store."""
        self._stop.set()
        self._drop_pending()
        try:
            self._pending.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join()
        self._drop_pending()
        self.store.shutdown()


# ---------------------------------------------------------------- reconstruct
def reconstruct_state(
    directory_url: str,
    owner: Optional[str] = None,
    step: Optional[int] = None,
    timeout: float = 30.0,
    on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    max_workers: int = 8,
    template: Optional[Any] = None,
) -> Tuple[int, Any, Dict[str, Any]]:
    """Pull every shard of one generation in parallel from its holders and
    decode; returns ``(step, state, stats)``.

    Failover is per shard: a shard slot that fails (dead holder, a torn
    pull past its resume budget, a crc32 mismatch) is marked missing, and
    the decode succeeds from any ``k`` that arrived. Raises when the
    directory has no generation or fewer than ``k`` shards arrive.

    ``step`` targets the generation a heal needs: announces ride an async
    worker, so the selection polls briefly (``min(2, max(0.25, timeout /
    10))`` s) until a live owner's newest generation is that step, and
    raises if none is by then, before anything is fetched or landed in
    ``template`` (the reference takes the newest and leaves the step
    check to its caller). A shard held by a retired incarnation (its store
    died with it) counts as failed without a fetch.
    ``template``: as ``unpack_state_blob``'s."""

    def _emit(kind: str, info: Dict[str, Any]) -> None:
        if on_event is not None:
            try:
                on_event(kind, info)
            except Exception:  # noqa: BLE001 - advisory
                logger.debug("reconstruct on_event failed", exc_info=True)

    t0 = time.monotonic()
    client = DirectoryClient(directory_url, timeout=min(timeout, 10.0))
    owner_arg = owner
    settle = min(2.0, max(0.25, timeout * 0.1)) if step is not None else 0.0
    entry: Optional[Dict[str, Any]] = None
    while True:
        d = client.get_directory()
        entries = d.get("entries", {})
        timed_out = time.monotonic() - t0 >= settle
        if owner_arg is not None:
            entry = entries.get(owner_arg)
            if entry is None:
                raise IOError(f"shard directory has no generation for {owner_arg!r}")
            owner = owner_arg
            if step is None or int(entry["step"]) == int(step):
                break
            if timed_out:
                raise IOError(f"{owner_arg!r} announced step {entry['step']}, not {step}, "
                              f"within {settle:.2f}s")
        else:
            if step is not None:
                dead = set(d.get("dead", []) or [])
                match = sorted(o for o, e in entries.items()
                               if int(e["step"]) == int(step) and o not in dead)
                if match:
                    owner, entry = match[0], entries[match[0]]
                    break
            if step is not None and timed_out:
                newest = {o: int(e["step"]) for o, e in entries.items()}
                raise IOError(f"no live owner announced step {step} within {settle:.2f}s "
                              f"(newest generations: {newest})")
            if step is None:
                latest = d.get("latest")
                if latest is None:
                    raise IOError("shard directory has no generations to reconstruct")
                owner = str(latest[0])
                entry = entries.get(owner)
                if entry is None:
                    raise IOError(f"shard directory has no generation for {owner!r}")
                break
        time.sleep(0.02)
    retired = set(d.get("retired", []) or [])
    k, m = int(entry["k"]), int(entry["m"])
    step = int(entry["step"])
    data_len = int(entry["data_len"])
    slen = shard_length(data_len, k)
    slots: List[Optional[Any]] = [None] * (k + m)
    # scatter-gather: a data shard of a systematic code IS a slice of the
    # blob, so it lands at its offset; when every data shard verifies the
    # blob is complete without a decode pass. Parity shards get buffers of
    # their own and feed only the repair of a missing data shard
    blob = np.empty(k * slen, dtype=np.uint8)
    blob_mv = memoryview(blob)
    stats = {
        "owner": owner,
        "step": step,
        "k": k,
        "m": m,
        "bytes": data_len,
        "shards_ok": 0,
        "shards_failed": 0,
        "shards_corrupt": 0,
    }

    def _fetch(spec: Dict[str, Any]) -> Tuple[int, Optional[Any], str]:
        idx = int(spec["idx"])
        if spec.get("holder") in retired:
            return idx, None, "failed"
        dest: Any = (blob_mv[idx * slen:(idx + 1) * slen] if idx < k
                     else memoryview(np.empty(slen, dtype=np.uint8)))
        try:
            get_shard_into(dest, spec["url"], owner, step, idx, slen, int(spec["crc"]),
                           timeout=timeout)
            return idx, dest, "ok"
        except IOError as e:
            return idx, None, "corrupt" if "crc32" in str(e) else "failed"
        except Exception:  # noqa: BLE001
            return idx, None, "failed"

    shard_specs = sorted(entry["shards"], key=lambda s: int(s["idx"]))
    with ThreadPoolExecutor(max_workers=min(max_workers, max(1, len(shard_specs)))) as pool:
        futs = {pool.submit(_fetch, s) for s in shard_specs}
        deadline = time.monotonic() + timeout
        ok = 0
        while futs:
            done, futs = wait(futs, timeout=max(0.0, deadline - time.monotonic()),
                              return_when=FIRST_COMPLETED)
            if not done:
                break
            for f in done:
                idx, body, verdict = f.result()
                if verdict == "ok":
                    slots[idx] = body
                    ok += 1
                    stats["shards_ok"] += 1
                else:
                    stats["shards_corrupt" if verdict == "corrupt" else "shards_failed"] += 1
                    _emit("shard_corrupt" if verdict == "corrupt" else "shard_fetch_failed",
                          {"owner": owner, "step": step, "idx": idx})
            # with every data shard in, the blob is complete: the parity
            # still in flight is not needed
            if ok >= k and all(slots[i] is not None for i in range(k)):
                for f in futs:
                    f.cancel()
                futs = set()
    if not all(slots[i] is not None for i in range(k)):
        # a missing data shard, rebuilt in its place in the blob; raises
        # ValueError when fewer than k shards arrived
        for d, row in missing_data_rows(slots, k, m, data_len).items():
            blob[d * slen:(d + 1) * slen] = row
    state = unpack_state_blob(blob_mv[:data_len], template=template)
    stats["reconstruct_s"] = time.monotonic() - t0
    stats["mb_per_s"] = data_len / (1024 * 1024) / max(stats["reconstruct_s"], 1e-9)
    _emit("reconstruct_done", dict(stats))
    return step, state, stats


# ---------------------------------------------------------------- HotSpare
class HotSpare:
    """A warm replacement replica: registers with the directory as a spare
    and prefetches every announced shard generation into resident host
    state. When the directory promotes it (a member died),
    ``wait_promoted`` returns the freshest resident state and the
    promotion record; ``Manager(spare=True).promote()`` loads it and joins
    the next quorum."""

    def __init__(
        self,
        cfg: RedundancyConfig,
        spare_id: str,
        poll_s: float = 0.1,
        serve_registry: Optional[str] = None,
        on_metric: Optional[Callable[[str, float], None]] = None,
    ) -> None:
        if not cfg.directory:
            raise ValueError("HotSpare requires a directory URL")
        self.cfg = cfg
        self.spare_id = spare_id
        self.pod = cfg.pod or pod_identity()
        self._poll_s = poll_s
        self._on_metric = on_metric or (lambda name, value: None)
        self._client = DirectoryClient(cfg.directory, timeout=cfg.timeout_s)
        self._lock = threading.Lock()
        self._state: Optional[Any] = None
        self._state_step = -1
        self._promotion: Optional[Dict[str, Any]] = None
        self._promoted = threading.Event()
        self._stop = threading.Event()
        self._serve_worker = None
        if serve_registry:
            # shadow the serving plane too (reference :1589-1605): the delta
            # chain advances the spare's flat between shard generations,
            # bitwise by the plane's error-feedback replay, a freshness
            # cross-check for a promotion. The flat stays on the host, where
            # the spare's prefetched state lives
            try:
                from torchft_tpu_torch.serving import ServeWorker

                self._serve_worker = ServeWorker(serve_registry, name=f"spare-{spare_id}",
                                                 device="cpu")
            except Exception:  # noqa: BLE001 - the spare works without it
                logger.exception("hot spare %s could not attach serve worker", spare_id)
        self._client.register(self.spare_id, self.pod, store_url="", spare=True)
        self._thread = threading.Thread(
            target=self._shadow_loop, daemon=True, name=f"torchft_hot_spare_{spare_id}"
        )
        self._thread.start()

    def _shadow_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                st = self._client.spare_status(self.spare_id)
                if st.get("promote"):
                    with self._lock:
                        self._promotion = st.get("promotion") or {}
                    self._promoted.set()
                    return
                self._prefetch_once()
            except Exception:  # noqa: BLE001 - keep shadowing
                logger.debug("hot spare shadow tick failed", exc_info=True)

    def _prefetch_once(self) -> None:
        d = self._client.get_directory()
        latest = d.get("latest")
        if latest is None:
            return
        owner, step = str(latest[0]), int(latest[1])
        with self._lock:
            if step <= self._state_step:
                return
        t0 = time.monotonic()
        got_step, state, _stats = reconstruct_state(
            self.cfg.directory, owner=owner, timeout=self.cfg.timeout_s
        )
        with self._lock:
            if got_step > self._state_step:
                self._state = state
                self._state_step = got_step
        self._on_metric("spare_prefetch_s", time.monotonic() - t0)
        self._on_metric("spare_prefetch_steps", 1)

    # -- public api --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            serve_version = None
            if self._serve_worker is not None:
                try:
                    serve_version = self._serve_worker.status().get("version")
                except Exception:  # noqa: BLE001
                    serve_version = None
            return {
                "spare_id": self.spare_id,
                "pod": self.pod,
                "prefetched_step": self._state_step,
                "promoted": self._promoted.is_set(),
                "promotion": dict(self._promotion or {}) or None,
                "serve_version": serve_version,
            }

    def prefetched_step(self) -> int:
        with self._lock:
            return self._state_step

    def wait_prefetched(self, step: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.prefetched_step() >= step:
                return True
            time.sleep(0.01)
        return False

    def wait_promoted(
        self, timeout: Optional[float] = None
    ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """Block until the directory promotes this spare: ``(state_step,
        state, promotion_record)``, or None on timeout."""
        if not self._promoted.wait(timeout):
            return None
        with self._lock:
            return self._state_step, self._state, dict(self._promotion or {})

    def shutdown(self) -> None:
        """Stop the shadow loop and join it (a prefetch in flight ends
        within ``timeout_s``) and the serve shadow's worker."""
        self._stop.set()
        self._thread.join()
        if self._serve_worker is not None:
            try:
                self._serve_worker.shutdown()
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------- CLI
def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchft_tpu_torch.redundancy --hot-spare``: shadow the
    fleet as a hot spare, printing a status line every
    ``--status-interval`` s, and print the promotion record and exit 0
    when promoted."""
    import argparse

    parser = argparse.ArgumentParser(prog="torchft_tpu_torch.redundancy",
                                     description="the redundancy plane's hot spare")
    parser.add_argument("--hot-spare", action="store_true",
                        help="prefetch shard generations; exit 0 printing the promotion "
                             "record when promoted")
    parser.add_argument("--directory", default=None,
                        help=f"ShardDirectory URL (default ${REDUNDANCY_DIRECTORY_ENV})")
    parser.add_argument("--spare-id", default=f"spare_{os.getpid()}",
                        help="the replica id the spare registers under")
    parser.add_argument("--serve-registry", default=None,
                        help="the serving plane's registry whose delta chain the spare "
                             "shadows between shard generations")
    parser.add_argument("--status-interval", type=float, default=2.0,
                        help="seconds between status lines")
    args = parser.parse_args(argv)
    if not args.hot_spare:
        parser.error("only --hot-spare mode is defined for this entry point")
    cfg = RedundancyConfig.from_env(directory=args.directory)
    if not cfg.directory:
        parser.error(f"--directory or ${REDUNDANCY_DIRECTORY_ENV} is required")
    logging.basicConfig(level=logging.INFO)
    spare = HotSpare(cfg, args.spare_id, serve_registry=args.serve_registry)
    try:
        while True:
            result = spare.wait_promoted(timeout=args.status_interval)
            if result is not None:
                step, _state, promo = result
                print(json.dumps({"promoted": True, "state_step": step, **promo}), flush=True)
                return 0
            print(json.dumps(spare.status()), flush=True)
    except KeyboardInterrupt:
        return 130
    finally:
        spare.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
