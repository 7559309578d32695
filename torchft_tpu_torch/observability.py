"""Structured event streams, profiler ranges and the Manager's ``/metrics``.

Counterpart of ``torchft_tpu/observability.py``. The event streams, each a
``logging`` logger whose records are JSON lines:

- ``torchft_quorums``: a quorum change (id, rank, world, heal);
- ``torchft_commits``: a ``should_commit`` decision;
- ``torchft_errors``: a reported error or a process group's abort;
- ``torchft_timings``: phase snapshots of a reconfigure and, with
  ``phase="allreduce_pipeline"``, of each streamed allreduce (the stage
  sums and ``overlap_efficiency``);
- ``torchft_health``: the healthwatch transitions a Manager sees of itself
  (``straggler_warn``, ``eject``, ``readmit``, ``recovered``);
- ``torchft_policy``: the policy plane's frames (not emitted by the port
  yet).

``TORCHFT_USE_OTEL=1`` mirrors every record to an OTLP exporter when the
``opentelemetry`` packages import, with resource attributes from
``TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON``; without them it is a no-op.
Per-step emitters go through ``emit_event_async``: a bounded queue and one
worker (``EventDrain``), which drops and counts rather than block a step.

``trace_span`` is ``torch.profiler.record_function``, the range the
reference's own ``trace_span`` was modelled on: the Manager's named ranges
(``torchft::manager::wait_quorum``, ...) land in a Kineto trace beside the
CUDA kernels of the same step. ``traced`` is its decorator form.

``MetricsRegistry`` renders Prometheus text exposition 0.0.4, byte for
byte as the reference renders it; ``MetricsServer`` serves one at
``/metrics`` (the lighthouse serves its own natively).
"""

from __future__ import annotations

import functools
import json
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from torch.profiler import record_function

from torchft_tpu_torch import knobs

__all__ = [
    "ALLREDUCE_PIPELINE_PHASE",
    "COMMIT_EVENTS",
    "DEFAULT_TIME_BUCKETS",
    "ERROR_EVENTS",
    "EventDrain",
    "EventLogger",
    "HEALTH_EVENTS",
    "METRICS_PORT_ENV",
    "MetricsRegistry",
    "MetricsServer",
    "POLICY_EVENTS",
    "QUORUM_EVENTS",
    "TIMING_EVENTS",
    "emit_event_async",
    "get_event_drain",
    "get_event_logger",
    "log_commit_event",
    "log_error_event",
    "log_health_event",
    "log_quorum_event",
    "log_timing_event",
    "trace_span",
    "traced",
]

USE_OTEL_ENV = "TORCHFT_USE_OTEL"
OTEL_RESOURCE_ATTRS_ENV = "TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON"
METRICS_PORT_ENV = "TORCHFT_METRICS_PORT"

QUORUM_EVENTS = "torchft_quorums"
COMMIT_EVENTS = "torchft_commits"
ERROR_EVENTS = "torchft_errors"
TIMING_EVENTS = "torchft_timings"
ALLREDUCE_PIPELINE_PHASE = "allreduce_pipeline"
HEALTH_EVENTS = "torchft_health"
POLICY_EVENTS = "torchft_policy"

_otel_loggers: Dict[str, Optional[logging.Logger]] = {}


def _shutdown_quietly(provider: Any) -> None:
    try:
        provider.shutdown()
    except Exception:  # noqa: BLE001 - an exit path never raises
        pass


def _resource_attributes() -> Dict[str, Any]:
    raw = knobs.env_raw(OTEL_RESOURCE_ATTRS_ENV)
    if not raw:
        return {}
    try:
        attrs = json.loads(raw)
    except json.JSONDecodeError:
        logging.getLogger(__name__).warning("invalid %s; ignoring", OTEL_RESOURCE_ATTRS_ENV)
        return {}
    return attrs if isinstance(attrs, dict) else {}


def _maybe_otel_logger(name: str) -> Optional[logging.Logger]:
    """An OTLP logger for stream ``name`` when ``TORCHFT_USE_OTEL`` asks for
    one and the opentelemetry SDK imports; else None (cached either way)."""
    if knobs.env_raw(USE_OTEL_ENV, "0") not in ("1", "true", "True"):
        return None
    if name in _otel_loggers:
        return _otel_loggers[name]
    try:
        from opentelemetry.exporter.otlp.proto.grpc._log_exporter import OTLPLogExporter
        from opentelemetry.sdk._logs import LoggerProvider, LoggingHandler
        from opentelemetry.sdk._logs.export import BatchLogRecordProcessor
        from opentelemetry.sdk.resources import Resource

        provider = LoggerProvider(
            resource=Resource.create({"service.name": name, **_resource_attributes()}))
        provider.add_log_record_processor(BatchLogRecordProcessor(OTLPLogExporter()))
        otel_logger = logging.getLogger(f"{name}.otlp")
        otel_logger.addHandler(LoggingHandler(logger_provider=provider))
        otel_logger.propagate = False
        # flush at exit: the last records (an error before a fatal exit)
        # are the ones an unflushed batch processor would drop
        import atexit

        atexit.register(lambda: _shutdown_quietly(provider))
    except Exception:  # noqa: BLE001 - the SDK is missing or misconfigured
        otel_logger = None
    _otel_loggers[name] = otel_logger
    return otel_logger


class EventLogger:
    """A named structured-event stream."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._logger = logging.getLogger(name)

    def log(self, **fields: Any) -> None:
        line = json.dumps({"event_time": time.time(), **fields}, default=str)
        self._logger.info(line)
        otel = _maybe_otel_logger(self.name)
        if otel is not None:
            otel.info(line)


_event_loggers: Dict[str, EventLogger] = {}


def get_event_logger(name: str) -> EventLogger:
    if name not in _event_loggers:
        _event_loggers[name] = EventLogger(name)
    return _event_loggers[name]


def log_quorum_event(**fields: Any) -> None:
    get_event_logger(QUORUM_EVENTS).log(**fields)


def log_commit_event(**fields: Any) -> None:
    get_event_logger(COMMIT_EVENTS).log(**fields)


def log_error_event(**fields: Any) -> None:
    get_event_logger(ERROR_EVENTS).log(**fields)


def log_timing_event(**fields: Any) -> None:
    get_event_logger(TIMING_EVENTS).log(**fields)


def log_health_event(**fields: Any) -> None:
    get_event_logger(HEALTH_EVENTS).log(**fields)


class EventDrain:
    """A bounded queue of events and one daemon worker that writes them to
    their streams, so a per-step caller pays an enqueue, not the JSON and
    the logging. When the queue is full the new event is dropped and
    counted (``dropped``): observability never holds a step back.
    ``flush`` waits until everything queued before it is written."""

    _FLUSH = "__flush__"

    def __init__(self, maxsize: int = 1024, autostart: bool = True) -> None:
        self._q: "queue.Queue[Tuple[str, Any]]" = queue.Queue(maxsize)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._autostart = autostart
        self._dropped = 0

    @property
    def dropped(self) -> int:
        """Events dropped because the queue was full."""
        with self._lock:
            return self._dropped

    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(target=self._run, name="torchft_event_drain",
                                            daemon=True)
            self._thread.start()

    def _handle(self, stream: str, payload: Any) -> None:
        try:
            if stream == self._FLUSH:
                payload.set()
                return
            get_event_logger(stream).log(**payload)
        except Exception:  # noqa: BLE001 - a bad event must not kill the drain
            logging.getLogger(__name__).exception("event drain failed to emit %s event", stream)
        finally:
            self._q.task_done()

    def _run(self) -> None:
        while True:
            self._handle(*self._q.get())

    def submit(self, stream: str, fields: Dict[str, Any]) -> bool:
        """Enqueue an event; False (and a drop counted) when full."""
        if self._autostart:
            self.start()
        try:
            self._q.put_nowait((stream, dict(fields)))
            return True
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False

    def flush(self, timeout: Optional[float] = 5.0) -> bool:
        """Wait until everything queued before this call is written; with
        no live worker (``autostart=False``) write it inline."""
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
        if not alive:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return True
                self._handle(*item)
        done = threading.Event()
        try:
            self._q.put((self._FLUSH, done), timeout=timeout)
        except queue.Full:
            return False
        return done.wait(timeout)


_event_drain: Optional[EventDrain] = None
_event_drain_lock = threading.Lock()


def get_event_drain() -> EventDrain:
    """The process's drain, shared by every per-step emitter."""
    global _event_drain
    with _event_drain_lock:
        if _event_drain is None:
            _event_drain = EventDrain()
        return _event_drain


def emit_event_async(stream: str, **fields: Any) -> bool:
    """Enqueue an event on the process's drain and return at once; rare
    events whose loss at a crash would matter (errors) take the
    synchronous ``log_*`` helpers."""
    return get_event_drain().submit(stream, fields)


# a named range in the profiler's trace (a no-op cost when no profiler runs)
trace_span = record_function


def traced(name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """``trace_span`` around a whole function."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with trace_span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ---------------------------------------------------------------- /metrics
# bucket bounds in seconds for phase-timing histograms: control-plane
# phases span ~100 us (a vote RPC on loopback) to tens of seconds (a heal)
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class MetricsRegistry:
    """Thread-safe registry rendering Prometheus text exposition 0.0.4."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gauges: Dict[str, Tuple[float, str]] = {}
        self._counters: Dict[str, Tuple[float, str]] = {}
        # name -> [help, bucket bounds, per-bucket counts, sum, count]
        self._hists: Dict[str, Any] = {}

    def gauge_set(self, name: str, value: float, help_: str = "") -> None:
        with self._lock:
            self._gauges[name] = (float(value), help_)

    def counter_set(self, name: str, value: float, help_: str = "") -> None:
        """Set a counter's absolute cumulative value (the sources keep
        cumulative counts; adding here would count them twice)."""
        with self._lock:
            self._counters[name] = (float(value), help_)

    def observe(
        self,
        name: str,
        value: float,
        help_: str = "",
        buckets: Tuple[float, ...] = DEFAULT_TIME_BUCKETS,
    ) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = [help_, tuple(buckets), [0] * (len(buckets) + 1), 0.0, 0]
                self._hists[name] = h
            bounds = h[1]
            i = next((j for j, b in enumerate(bounds) if value <= b), len(bounds))
            h[2][i] += 1
            h[3] += float(value)
            h[4] += 1

    def render(self) -> str:
        out = []
        with self._lock:
            for name in sorted(self._gauges):
                value, help_ = self._gauges[name]
                if help_:
                    out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} gauge")
                out.append(f"{name} {value}")
            for name in sorted(self._counters):
                value, help_ = self._counters[name]
                if help_:
                    out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} counter")
                out.append(f"{name} {value}")
            for name in sorted(self._hists):
                help_, bounds, counts, total, n = self._hists[name]
                if help_:
                    out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    out.append(f'{name}_bucket{{le="{b}"}} {cum}')
                cum += counts[-1]
                out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                out.append(f"{name}_sum {total}")
                out.append(f"{name}_count {n}")
        return "\n".join(out) + "\n"


class MetricsServer:
    """A threaded HTTP server of one registry at ``/metrics`` (and ``/``).
    ``refresh``, when given, runs before each render: the Manager syncs its
    timings into the registry only when a scrape comes. A failed refresh or
    render answers 500; another path 404."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
        refresh: Optional[Callable[[], None]] = None,
    ) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - http.server's name
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    if refresh is not None:
                        refresh()
                    body = registry.render().encode()
                except Exception:  # noqa: BLE001 - a scrape never crashes the server
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:  # quiet per scrape
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="torchft_metrics", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - teardown never raises
            pass
        self._thread.join(timeout=5.0)
