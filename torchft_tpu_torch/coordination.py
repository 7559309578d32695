"""ctypes binding to the repo's native C++ control plane.

Counterpart of ``torchft_tpu/coordination.py``: ``LighthouseServer`` /
``LighthouseClient``, ``AggregatorServer`` (the pod tier of the two-level
control plane), ``ManagerServer`` / ``ManagerClient``, the rendezvous
``KvStoreServer`` / ``KvClient`` and the ``QuorumResult`` type. The native
side speaks length-framed JSON over TCP; ctypes releases the GIL around
every blocking call.

This package builds its OWN shared library from ``native/*.cc`` (the
Makefile's sources plus ``capi.cc``) straight into
``torchft_tpu_torch/_native/``, one ``g++`` per source started together,
under its own file lock. The library's name carries a hash of the native
sources, headers, flags and the compiler's version, so an edited source,
or a tree copied to a machine with another toolchain, rebuilds. It never loads the JAX package's library and never
runs ``make`` (which writes ``native/*.o`` and would race that package's
build).

Every RPC runs under the reference's bounded retry layer (``_RawClient``,
``torchft_tpu/coordination.py:795-930``): ``RetryPolicy.from_env()``
(``TORCHFT_RETRY_*``; ``TORCHFT_RETRY_MAX_ATTEMPTS=1`` disables it) with
the caller's timeout as the deadline budget, full jitter after a
connection loss and bounded jitter after a timeout, and the last
underlying exception re-raised on exhaustion. ``retry=False`` opts a call
out (non-idempotent or fire-and-forget RPCs); ``set_retry_observer`` on a
client sees every retry; ``set_rpc_fault_hook`` injects RPC faults in
tests. A quorum result names, beyond its assigned recovery source, the
other up-to-date peers a healing replica may fail over to
(``recover_src_fallbacks``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import subprocess
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Tuple

from torchft_tpu_torch.healthwatch import HealthConfig
from torchft_tpu_torch.retry import RetryBudgetExhausted, RetryPolicy, retry_call

__all__ = [
    "AggregatorServer",
    "FallbackPeer",
    "QuorumResult",
    "LighthouseServer",
    "LighthouseClient",
    "ManagerServer",
    "ManagerClient",
    "KvStoreServer",
    "KvClient",
    "ensure_native_built",
    "health_replay",
    "health_scores",
    "history_replay",
    "set_rpc_fault_hook",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SRC = os.path.join(_REPO_ROOT, "native")
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
# native/Makefile's SRCS, plus the C API the bindings call
_SOURCES = (
    "json", "net", "wire", "quorum", "healthwatch", "history", "kvstore",
    "lighthouse", "aggregator", "manager_server", "capi",
)
_CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")
# a compiler that links the C++ runtime statically (as the H100 machine's
# $CXX does) puts a second libstdc++ in a process that already has torch's:
# its symbols must bind inside the library, or the two runtimes' iostream
# and locale state meet and a formatted double (the lighthouse's /metrics)
# faults
_LDFLAGS = ("-shared", "-pthread", "-Wl,--exclude-libs,ALL")

# status codes from native/capi.cc
_OK, _TIMEOUT, _ERROR, _NOT_FOUND, _INVALID, _UNAVAILABLE = range(6)


def _so_path(cxx: str) -> str:
    """The library's path, named by a hash of every native source and
    header, the compiler (its ``--version``: a tree copied to a machine
    with another toolchain builds anew) and the flags."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join((cxx, version, *_CXXFLAGS, *_LDFLAGS)).encode())
    files = [os.path.join(_NATIVE_SRC, f"{name}.cc") for name in _SOURCES]
    files += sorted(glob.glob(os.path.join(_NATIVE_SRC, "*.h")))
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(_NATIVE_DIR, f"libtorchft_tpu_torch-{h.hexdigest()[:16]}.so")


def ensure_native_built() -> str:
    """Build the control-plane library into ``_native/`` if it is missing.

    One ``g++ -c`` per source runs in parallel, then one link to a
    temporary name that is renamed into place, all under a file lock so
    concurrent processes (pytest workers) build it once."""
    cxx = os.environ.get("CXX", "g++")
    so_path = _so_path(cxx)
    if os.path.exists(so_path):
        return so_path
    import fcntl

    os.makedirs(_NATIVE_DIR, exist_ok=True)
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so_path):
                _build(cxx, so_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so_path


def _build(cxx: str, so_path: str) -> None:
    objs = []
    procs = []
    for name in _SOURCES:
        obj = os.path.join(_NATIVE_DIR, f"{name}.{os.getpid()}.o")
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [cxx, *_CXXFLAGS, "-c", os.path.join(_NATIVE_SRC, f"{name}.cc"),
             "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cc:\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("native control-plane build failed:\n" + "\n".join(failed))
    tmp = f"{so_path}.{os.getpid()}.tmp"
    subprocess.run([cxx, *_LDFLAGS, "-o", tmp, *objs], check=True)
    os.replace(tmp, so_path)
    for obj in objs:
        os.remove(obj)


_lib: Optional[ctypes.CDLL] = None

_P = ctypes.POINTER


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_native_built())
    vp, cp, i64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
    sigs = {
        "tft_free": ([cp], None),
        "tft_lighthouse_new_v2": ([cp, _P(vp), _P(cp)], ctypes.c_int),
        "tft_lighthouse_address": ([vp], vp),
        "tft_lighthouse_port": ([vp], ctypes.c_int),
        "tft_lighthouse_shutdown": ([vp], None),
        "tft_lighthouse_free": ([vp], None),
        "tft_lighthouse_retune_health": ([vp, cp, _P(cp), _P(cp)], ctypes.c_int),
        "tft_aggregator_new": ([cp, _P(vp), _P(cp)], ctypes.c_int),
        "tft_aggregator_address": ([vp], vp),
        "tft_aggregator_port": ([vp], ctypes.c_int),
        "tft_aggregator_status": ([vp], vp),
        "tft_aggregator_shutdown": ([vp], None),
        "tft_aggregator_free": ([vp], None),
        "tft_manager_new": ([cp, _P(vp), _P(cp)], ctypes.c_int),
        "tft_manager_control_status": ([vp], vp),
        "tft_manager_publish_telemetry": ([vp, cp, _P(cp)], ctypes.c_int),
        "tft_manager_health": ([vp], vp),
        "tft_manager_clock_skew": ([vp], vp),
        "tft_manager_address": ([vp], vp),
        "tft_manager_port": ([vp], ctypes.c_int),
        "tft_manager_shutdown": ([vp], None),
        "tft_manager_free": ([vp], None),
        "tft_client_new": ([cp, i64, _P(vp), _P(cp)], ctypes.c_int),
        "tft_client_free": ([vp], None),
        "tft_client_call": ([vp, cp, cp, i64, _P(cp), _P(cp)], ctypes.c_int),
        "tft_kvstore_new": ([cp, _P(vp), _P(cp)], ctypes.c_int),
        "tft_kvstore_port": ([vp], ctypes.c_int),
        "tft_kvstore_shutdown": ([vp], None),
        "tft_kvstore_free": ([vp], None),
        "tft_health_scores": ([cp, cp, _P(cp), _P(cp)], ctypes.c_int),
        "tft_health_replay": ([cp, cp, _P(cp), _P(cp)], ctypes.c_int),
        "tft_history_replay": ([cp, _P(cp), _P(cp)], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def _take_str(lib: ctypes.CDLL, ptr: "ctypes.c_char_p | int | None") -> str:
    if not ptr:
        return ""
    try:
        raw = ctypes.cast(ptr, ctypes.c_char_p).value or b""
        return raw.decode("utf-8", errors="replace")
    finally:
        lib.tft_free(ctypes.cast(ptr, ctypes.c_char_p))


def _raise_for_status(status: int, err: str, what: str) -> None:
    if status == _OK:
        return
    msg = f"{what}: {err}" if err else what
    if status == _TIMEOUT:
        raise TimeoutError(msg)
    if status == _NOT_FOUND:
        raise LookupError(msg)
    if status == _INVALID:
        raise ValueError(msg)
    raise RuntimeError(msg)


def _ms(timeout: "float | timedelta") -> int:
    if isinstance(timeout, timedelta):
        return int(timeout.total_seconds() * 1000)
    return int(timeout * 1000)


def _new_handle(ctor: str, arg: bytes, what: str) -> Tuple[ctypes.CDLL, ctypes.c_void_p]:
    lib = _load()
    handle = ctypes.c_void_p()
    err = ctypes.c_char_p()
    status = getattr(lib, ctor)(arg, ctypes.byref(handle), ctypes.byref(err))
    _raise_for_status(status, _take_str(lib, err), what)
    return lib, handle


# --------------------------------------------------------------------- types
@dataclass
class FallbackPeer:
    """An up-to-date peer a healing replica can fail over to if its assigned
    recovery source dies mid-transfer."""

    replica_rank: int
    address: str  # manager RPC address (host:port)

    @staticmethod
    def _from_json(d: dict) -> "FallbackPeer":
        return FallbackPeer(replica_rank=d.get("replica_rank", 0), address=d.get("address", ""))


@dataclass
class QuorumResult:
    """Per-rank manager quorum response (same fields as the reference's)."""

    quorum_id: int
    replica_rank: int
    replica_world_size: int
    recover_src_manager_address: str
    recover_src_replica_rank: Optional[int]
    recover_dst_replica_ranks: List[int]
    store_address: str
    max_step: int
    max_replica_rank: Optional[int]
    max_world_size: int
    heal: bool
    commit_failures: int = 0
    replica_ids: List[str] = field(default_factory=list)
    # the other max-step peers, in the native quorum's round-robin order
    # after the assigned source; empty when not healing
    recover_src_fallbacks: List[FallbackPeer] = field(default_factory=list)

    @staticmethod
    def _from_json(d: dict) -> "QuorumResult":
        return QuorumResult(
            quorum_id=d["quorum_id"],
            replica_rank=d["replica_rank"],
            replica_world_size=d["replica_world_size"],
            recover_src_manager_address=d.get("recover_src_manager_address", ""),
            recover_src_replica_rank=d.get("recover_src_replica_rank"),
            recover_dst_replica_ranks=list(d.get("recover_dst_replica_ranks", [])),
            store_address=d.get("store_address", ""),
            max_step=d.get("max_step", 0),
            max_replica_rank=d.get("max_replica_rank"),
            max_world_size=d.get("max_world_size", 0),
            heal=d.get("heal", False),
            commit_failures=d.get("commit_failures", 0),
            replica_ids=list(d.get("replica_ids", [])),
            recover_src_fallbacks=[
                FallbackPeer._from_json(f) for f in d.get("recover_src_fallbacks", [])
            ],
        )


# ------------------------------------------------------------------- servers
class _Server:
    _prefix = ""

    def __init__(self, lib: ctypes.CDLL, handle: ctypes.c_void_p) -> None:
        self._lib = lib
        self._handle = handle

    @property
    def port(self) -> int:
        return getattr(self._lib, f"tft_{self._prefix}_port")(self._handle)

    def shutdown(self) -> None:
        if self._handle:
            getattr(self._lib, f"tft_{self._prefix}_shutdown")(self._handle)

    def __del__(self) -> None:
        try:
            if getattr(self, "_handle", None):
                getattr(self._lib, f"tft_{self._prefix}_free")(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class LighthouseServer(_Server):
    """In-process lighthouse quorum server (native C++) with its health
    ledger and its own ``/metrics``, ``/health`` and ``/status`` beside the
    RPC port.

    ``health`` is the ledger's options (``HealthConfig.to_json()``'s
    fields; reference ``coordination.py:336-403``): None reads
    ``TORCHFT_HEALTH_*`` (``HealthConfig.from_env()``, observe mode by
    default). ``history_path`` turns on the recorded history: an
    append-only JSONL of quorum transitions, heals, health events and
    telemetry snapshots, read back by ``history_replay`` or ``python -m
    torchft_tpu_torch.trace history`` (empty: off).
    ``redundancy_directory=True`` co-hosts the redundancy plane's
    ``ShardDirectory`` (reference ``coordination.py:348``, ``:428-440``):
    it tracks where each replica's erasure-coded shard generations live,
    polls this lighthouse's health ledger for deaths and promotes hot
    spares; ``redundancy_directory_url()`` is its URL (None without it).
    ``serve_registry=True`` co-hosts the serving plane's
    ``SnapshotRegistry`` (reference ``coordination.py:346-347``,
    ``:413-425``): it polls this lighthouse's ``/health`` to drain
    unhealthy sources at ``serve_drain_on`` ("warn" or "eject"; None reads
    ``TORCHFT_SERVE_DRAIN_ON``, "warn" when unset); ``serve_registry_url()``
    is its URL (None without it)."""

    _prefix = "lighthouse"

    def __init__(
        self,
        bind: str = "0.0.0.0:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 60000,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        redundancy_directory: bool = False,
        health: Optional[dict] = None,
        history_path: str = "",
        serve_registry: bool = False,
        serve_drain_on: Optional[str] = None,
    ) -> None:
        if health is None:
            health = HealthConfig.from_env().to_json()
        opts = {
            "bind": bind,
            "min_replicas": min_replicas,
            "join_timeout_ms": join_timeout_ms,
            "quorum_tick_ms": quorum_tick_ms,
            "heartbeat_timeout_ms": heartbeat_timeout_ms,
            "health": health,
            "history_path": history_path,
        }
        super().__init__(*_new_handle(
            "tft_lighthouse_new_v2", json.dumps(opts).encode(),
            "lighthouse start failed",
        ))
        self.serve_registry = None
        if serve_registry:
            # lazy: serving.py imports LighthouseClient back from here for
            # the registry's health poll
            from torchft_tpu_torch import knobs
            from torchft_tpu_torch.serving import SERVE_DRAIN_ON_ENV, SnapshotRegistry

            drain_on = serve_drain_on
            if drain_on is None:
                drain_on = (knobs.env_raw(SERVE_DRAIN_ON_ENV) or "").strip() or "warn"
            self.serve_registry = SnapshotRegistry(lighthouse_addr=self.address(),
                                                   drain_on=drain_on)
        self.redundancy_directory = None
        if redundancy_directory:
            # lazy: redundancy.py imports LighthouseClient back from here
            # for the directory's health poll
            from torchft_tpu_torch.redundancy import ShardDirectory

            self.redundancy_directory = ShardDirectory(lighthouse_addr=self.address())

    def address(self) -> str:
        return _take_str(self._lib, self._lib.tft_lighthouse_address(self._handle))

    def serve_registry_url(self) -> Optional[str]:
        return self.serve_registry.url if self.serve_registry is not None else None

    def redundancy_directory_url(self) -> Optional[str]:
        return self.redundancy_directory.url if self.redundancy_directory is not None else None

    def retune_health(self, partial: dict) -> dict:
        """Merge ``partial`` health options over the running ledger's and
        return the result (reference ``coordination.py:509``)."""
        out = ctypes.c_char_p()
        err = ctypes.c_char_p()
        status = self._lib.tft_lighthouse_retune_health(
            self._handle, json.dumps(partial).encode(), ctypes.byref(out), ctypes.byref(err))
        out_s = _take_str(self._lib, out)
        _raise_for_status(status, _take_str(self._lib, err), "retune_health failed")
        return json.loads(out_s or "{}")

    def shutdown(self) -> None:
        if self.serve_registry is not None:
            self.serve_registry.shutdown()
            self.serve_registry = None
        if self.redundancy_directory is not None:
            self.redundancy_directory.shutdown()
        super().shutdown()


class AggregatorServer(_Server):
    """Pod-level lighthouse aggregator (native C++, ``native/aggregator.cc``;
    reference ``coordination.py:568-630``).

    Downstream it speaks the lighthouse's protocol (``heartbeat``,
    ``quorum``, ``GET /status``), so a Manager points at it through
    ``TORCHFT_LIGHTHOUSE_AGGREGATOR`` with nothing else changed; upstream it
    batches the pod into one delta-encoded ``agg_tick`` RPC a tick to the
    root lighthouse and fans the quorum results back out."""

    _prefix = "aggregator"

    def __init__(
        self,
        root_addr: str,
        bind: str = "0.0.0.0:0",
        agg_id: str = "",
        tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        connect_timeout: "float | timedelta" = 10.0,
    ) -> None:
        opts = {
            "bind": bind,
            "root_addr": root_addr,
            "agg_id": agg_id,
            "tick_ms": tick_ms,
            "heartbeat_timeout_ms": heartbeat_timeout_ms,
            "connect_timeout_ms": _ms(connect_timeout),
        }
        super().__init__(*_new_handle(
            "tft_aggregator_new", json.dumps(opts).encode(), "aggregator start failed"
        ))

    def address(self) -> str:
        return _take_str(self._lib, self._lib.tft_aggregator_address(self._handle))

    def status(self) -> dict:
        """The pod and its upstream: ``pod_size`` / ``pod_live``,
        ``joiners_pending``, ``ticks_ok`` / ``ticks_failed``,
        ``upstream_bytes``, ``last_tick_ok``, ``last_error``."""
        return json.loads(
            _take_str(self._lib, self._lib.tft_aggregator_status(self._handle)) or "{}")


class ManagerServer(_Server):
    """Per-replica-group manager server (native C++): forwards quorum
    requests to the lighthouse, heartbeats, and gathers commit votes.

    ``aggregator_addr`` points the heartbeat and quorum RPCs at a pod
    aggregator (``AggregatorServer``); empty: straight to the lighthouse.
    The server fails over to the lighthouse on its own when the aggregator
    dies, and re-points when the root names a replacement
    (``control_status()``)."""

    _prefix = "manager"

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        hostname: str = "",
        bind: str = "0.0.0.0:0",
        store_addr: str = "",
        world_size: int = 1,
        heartbeat_interval: "float | timedelta" = 0.1,
        connect_timeout: "float | timedelta" = 10.0,
        quorum_retries: int = 0,
        aggregator_addr: str = "",
    ) -> None:
        opts = {
            "replica_id": replica_id,
            "lighthouse_addr": lighthouse_addr,
            "hostname": hostname,
            "bind": bind,
            "store_addr": store_addr,
            "world_size": world_size,
            "heartbeat_interval_ms": _ms(heartbeat_interval),
            "connect_timeout_ms": _ms(connect_timeout),
            "quorum_retries": quorum_retries,
            "aggregator_addr": aggregator_addr,
        }
        super().__init__(*_new_handle(
            "tft_manager_new", json.dumps(opts).encode(), "manager start failed"
        ))

    def address(self) -> str:
        return _take_str(self._lib, self._lib.tft_manager_address(self._handle))

    def publish_telemetry(self, telemetry: dict) -> None:
        """Set the per-step telemetry every later heartbeat carries (the
        lighthouse's ledger reads ``step``, ``step_s``, ``wire_s``; the rest
        rides along to ``/health``)."""
        err = ctypes.c_char_p()
        status = self._lib.tft_manager_publish_telemetry(
            self._handle, json.dumps(telemetry).encode(), ctypes.byref(err))
        _raise_for_status(status, _take_str(self._lib, err), "publish_telemetry failed")

    def health(self) -> dict:
        """This replica's health summary from the last heartbeat's answer
        (``state``, ``state_code``, ``score``, ``ejections``,
        ``readmissions``); ``{}`` until a beat has returned."""
        return json.loads(_take_str(self._lib, self._lib.tft_manager_health(self._handle)) or "{}")

    def clock_skew(self) -> dict:
        """This host's clock minus the lighthouse's, from heartbeat round
        trips: ``skew_ms`` / ``rtt_ms`` of the fastest beat, ``samples`` (0
        before the first beat returned)."""
        return json.loads(
            _take_str(self._lib, self._lib.tft_manager_clock_skew(self._handle)) or "{}")

    def control_status(self) -> dict:
        """The two-level control plane as this server sees it:
        ``aggregator_addr``, ``via_aggregator``, ``direct_mode`` and
        ``failovers``: which upstream the heartbeat and quorum RPCs use now."""
        return json.loads(
            _take_str(self._lib, self._lib.tft_manager_control_status(self._handle)) or "{}")


class KvStoreServer(_Server):
    """Rendezvous key-value store server (native C++)."""

    _prefix = "kvstore"

    def __init__(self, bind: str = "0.0.0.0:0") -> None:
        super().__init__(*_new_handle(
            "tft_kvstore_new", bind.encode(), "kvstore start failed"
        ))


# ------------------------------------------------------------------- clients
# Test-only fault injection: called before every RPC attempt with (method,
# addr); it may sleep (a slow link) and return an exception to raise in
# place of the call (a flaky or partitioned server).
_rpc_fault_hook: Optional[Callable[[str, str], Optional[Exception]]] = None


def set_rpc_fault_hook(hook: Optional[Callable[[str, str], Optional[Exception]]]) -> None:
    """Install (or clear, with None) the process-wide RPC fault hook."""
    global _rpc_fault_hook
    _rpc_fault_hook = hook


# connection-class failures (_UNAVAILABLE and _ERROR raise RuntimeError,
# stalls TimeoutError) are retried; _NOT_FOUND and _INVALID are answers
_RETRYABLE_RPC_ERRORS = (TimeoutError, RuntimeError, ConnectionError)
# a restarted server drops every client at once: their retries back off
# with full jitter so the reconnects spread over the whole window;
# timeouts keep the bounded jitter, which paces the deadline
_FULL_JITTER_RPC_ERRORS = (ConnectionError, RuntimeError)


def _seconds(timeout: "float | timedelta") -> float:
    return timeout.total_seconds() if isinstance(timeout, timedelta) else float(timeout)


class _RawClient:
    """Framed-JSON RPC client over the native transport.

    Every call runs under the retry policy with the caller's timeout as the
    whole budget; the native client re-dials a stale connection on each
    attempt, so a server blip shorter than the budget is a slower call, not
    an error. On exhaustion the last underlying exception is re-raised, so
    callers see the exception types a single attempt gives."""

    def __init__(
        self,
        addr: str,
        connect_timeout: "float | timedelta" = 10.0,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        self._lib = _load()
        handle = ctypes.c_void_p()
        err = ctypes.c_char_p()
        status = self._lib.tft_client_new(
            addr.encode(), _ms(connect_timeout), ctypes.byref(handle),
            ctypes.byref(err),
        )
        _raise_for_status(status, _take_str(self._lib, err), "client create failed")
        self._handle = handle
        self.addr = addr
        self._retry_policy = retry_policy if retry_policy is not None else RetryPolicy.from_env()
        # (method, attempt, prior exception) before every retry attempt
        self.on_retry: Optional[Callable[[str, int, BaseException], None]] = None

    def call(
        self, method: str, params: dict, timeout: "float | timedelta", retry: bool = True
    ) -> dict:
        """One RPC under the retry policy; ``retry=False`` makes exactly one
        attempt (non-idempotent or fire-and-forget RPCs)."""
        params_json = json.dumps(params).encode()
        policy = self._retry_policy
        if not retry or not policy.enabled:
            return self._call_once(method, params_json, timeout)

        def on_attempt(attempt: int, prior: Optional[BaseException]) -> None:
            if attempt > 1 and prior is not None and self.on_retry is not None:
                self.on_retry(method, attempt, prior)

        try:
            return retry_call(
                lambda remaining: self._call_once(method, params_json, remaining),
                policy,
                timeout=_seconds(timeout),
                retryable=_RETRYABLE_RPC_ERRORS,
                full_jitter_on=_FULL_JITTER_RPC_ERRORS,
                on_attempt=on_attempt,
            )
        except RetryBudgetExhausted as e:
            assert e.last_exception is not None
            raise e.last_exception from e

    def _call_once(self, method: str, params_json: bytes, timeout: "float | timedelta") -> dict:
        hook = _rpc_fault_hook
        if hook is not None:
            injected = hook(method, self.addr)
            if injected is not None:
                raise injected
        result = ctypes.c_char_p()
        err = ctypes.c_char_p()
        status = self._lib.tft_client_call(
            self._handle, method.encode(), params_json,
            _ms(timeout), ctypes.byref(result), ctypes.byref(err),
        )
        err_s = _take_str(self._lib, err)
        result_s = _take_str(self._lib, result)
        _raise_for_status(status, err_s, f"{method} to {self.addr} failed")
        return json.loads(result_s) if result_s else {}

    def __del__(self) -> None:
        try:
            if getattr(self, "_handle", None):
                self._lib.tft_client_free(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class _Client:
    """A client of one service: its ``_RawClient`` and retry observer."""

    def __init__(
        self,
        addr: str,
        connect_timeout: "float | timedelta" = 10.0,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        self._client = _RawClient(addr, connect_timeout, retry_policy)

    def set_retry_observer(
        self, fn: Optional[Callable[[str, int, BaseException], None]]
    ) -> None:
        """``fn(method, attempt, prior_exc)`` runs before each retry attempt
        (never before the first)."""
        self._client.on_retry = fn


class LighthouseClient(_Client):
    """Client for the lighthouse service (status, heartbeats and health)."""

    def heartbeat(self, replica_id: str, timeout: "float | timedelta" = 5.0) -> dict:
        return self._client.call("heartbeat", {"replica_id": replica_id}, timeout)

    def status(self, timeout: "float | timedelta" = 5.0) -> dict:
        return self._client.call("status", {}, timeout)

    def health(self, timeout: "float | timedelta" = 5.0) -> dict:
        """The native health ledger's dump (reference ``coordination.py:999``):
        ``replicas`` (each one's ``state``, ``score``, ``last_beat_ms_ago``,
        ...), ``excluded``, ``recent_events``, ``mode``."""
        return self._client.call("health", {}, timeout)


class ManagerClient(_Client):
    """Client for a replica group's manager service."""

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout: "float | timedelta",
        init_sync: bool = True,
        commit_failures: int = 0,
    ) -> QuorumResult:
        resp = self._client.call(
            "quorum",
            {
                "group_rank": group_rank,
                "step": step,
                "checkpoint_metadata": checkpoint_metadata,
                "shrink_only": shrink_only,
                "init_sync": init_sync,
                "commit_failures": commit_failures,
            },
            timeout,
        )
        return QuorumResult._from_json(resp)

    def _checkpoint_metadata(self, rank: int, timeout: "float | timedelta") -> str:
        resp = self._client.call("checkpoint_metadata", {"rank": rank}, timeout)
        return resp["checkpoint_metadata"]

    def should_commit(
        self,
        group_rank: int,
        step: int,
        should_commit: bool,
        timeout: "float | timedelta",
    ) -> bool:
        resp = self._client.call(
            "should_commit",
            {"group_rank": group_rank, "should_commit": should_commit, "step": step},
            timeout,
        )
        return resp["should_commit"]


class KvClient(_Client):
    """Client for the rendezvous KV store (values are bytes, carried as
    ``b64:``-prefixed base64 on the wire)."""

    def set(self, key: str, value: "bytes | str", timeout: "float | timedelta" = 10.0) -> None:
        import base64

        if isinstance(value, str):
            value = value.encode()
        self._client.call(
            "set",
            {"key": key, "value": "b64:" + base64.b64encode(value).decode()},
            timeout,
        )

    def get(
        self, key: str, timeout: "float | timedelta" = 10.0, wait: bool = True
    ) -> bytes:
        import base64

        value = self._client.call("get", {"key": key, "wait": wait}, timeout)["value"]
        if value.startswith("b64:"):
            return base64.b64decode(value[4:])
        return value.encode()


# ------------------------------------------------ the health plane's replays
def _native_call(fn: str, what: str, *args: bytes) -> dict:
    lib = _load()
    result = ctypes.c_char_p()
    err = ctypes.c_char_p()
    status = getattr(lib, fn)(*args, ctypes.byref(result), ctypes.byref(err))
    err_s = _take_str(lib, err)
    result_s = _take_str(lib, result)
    _raise_for_status(status, err_s, what)
    return json.loads(result_s)


def health_scores(windows: Dict[str, list], opts: dict) -> Dict[str, float]:
    """The native ledger's straggler scores of ``windows`` (reference
    ``coordination.py:1183``): held against ``healthwatch.straggler_scores``
    by the tests."""
    return _native_call("tft_health_scores", "health_scores failed",
                        json.dumps(windows).encode(), json.dumps(opts).encode())


def health_replay(script: list, opts: dict) -> dict:
    """A scripted run of beats and ticks through the native ledger on a
    synthetic clock; returns ``{"events", "ledger", "excluded"}``
    (reference ``:1202``). Entries: ``{"t_ms", "replica_id",
    "telemetry"?}`` beats and ``{"t_ms", "tick": true}`` ticks; ``opts`` is
    the health options plus ``heartbeat_timeout_ms`` and ``min_replicas``."""
    return _native_call("tft_health_replay", "health_replay failed",
                        json.dumps(script).encode(), json.dumps(opts).encode())


def history_replay(jsonl_text: str) -> dict:
    """A recorded history (JSONL content, or a path to a plain or gzipped
    file) through the native read path: ``{"events", "summary"}``
    (reference ``:1224``); ``tracing.history_fold`` is its Python twin."""
    from torchft_tpu_torch.tracing import load_history

    normalized = "\n".join(json.dumps(e) for e in load_history(jsonl_text))
    return _native_call("tft_history_replay", "history_replay failed", normalized.encode())
