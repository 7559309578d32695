"""The tracing plane: a span recorder per Manager, the skew-corrected
Chrome-trace merge, and the recorded-history fold.

Counterpart of ``torchft_tpu/tracing.py``.

- ``SpanRecorder``: a bounded ring of spans the Manager records around its
  control-plane and wire phases (quorum, prepare and commit of a
  reconfigure, each bucket's pack, wire and unpack, heal, commit vote,
  retries, re-routes, health transitions). Each span carries ``(quorum_id,
  step)`` and the recorder's replica, so spans of one step correlate across
  replicas without a shared clock. Recording is a dict append under one
  lock; a full ring drops its oldest span and counts it (``dropped``).
- Clock skew: each export carries the replica's skew against the
  lighthouse (``ManagerServer.clock_skew()``, from heartbeat round trips)
  and ``merge_traces`` moves every replica onto the lighthouse's clock.
- ``merge_traces`` / ``python -m torchft_tpu_torch.trace merge``: N dumps
  in, one Chrome-trace JSON out (Perfetto, chrome://tracing): one process
  row a replica, one thread row a span category.
- ``history_fold``: the Python fold of the lighthouse's recorded history
  (JSONL), the twin of the native ``coordination.history_replay``.

Knobs (``TraceConfig.from_env``): ``TORCHFT_TRACE`` (on unless "0", "off",
"false" or "no"), ``TORCHFT_TRACE_BUFFER`` (4096 spans, at least 16),
``TORCHFT_TRACE_SAMPLE`` (the share of steps kept, 1.0, chosen by a hash of
the step so every replica keeps the same steps), ``TORCHFT_TRACE_DIR``
(where ``dump()`` writes; empty: beside the flight recorder's
``TORCHFT_FR_BASE_PATH``).
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Deque, Dict, Iterable, List, Optional

from torchft_tpu_torch import knobs

TRACE_ENV = "TORCHFT_TRACE"
TRACE_BUFFER_ENV = "TORCHFT_TRACE_BUFFER"
TRACE_SAMPLE_ENV = "TORCHFT_TRACE_SAMPLE"
TRACE_DIR_ENV = "TORCHFT_TRACE_DIR"

_DEFAULT_BUFFER = 4096

__all__ = [
    "TraceConfig",
    "SpanRecorder",
    "step_sampled",
    "merge_traces",
    "history_fold",
    "load_history",
    "parse_history",
    "set_clock_offset_ms",
    "clear_clock_offsets",
]


# test hooks: a replica's clock made to run ahead by an offset. It shifts
# the recorder's stamps and its exported skew alike, as a host with a fast
# clock does, so the merge's correction is what a test exercises
_clock_offsets: Dict[str, float] = {}
_clock_offsets_lock = threading.Lock()


def set_clock_offset_ms(replica_id: str, offset_ms: float) -> None:
    """Tests: ``replica_id``'s clock (matched exactly or by prefix) runs
    ``offset_ms`` ahead."""
    with _clock_offsets_lock:
        _clock_offsets[replica_id] = float(offset_ms)


def clear_clock_offsets() -> None:
    with _clock_offsets_lock:
        _clock_offsets.clear()


def _offset_ms_for(replica_id: str) -> float:
    with _clock_offsets_lock:
        if not _clock_offsets:
            return 0.0
        if replica_id in _clock_offsets:
            return _clock_offsets[replica_id]
        for key, off in _clock_offsets.items():
            if replica_id.startswith(key):
                return off
    return 0.0


@dataclass
class TraceConfig:
    enabled: bool = True
    buffer: int = _DEFAULT_BUFFER
    sample: float = 1.0
    dump_dir: str = ""

    @classmethod
    def from_env(cls) -> "TraceConfig":
        """From ``TORCHFT_TRACE*``; a value that does not parse gives the
        default (a bad observability knob never stops training)."""
        cfg = cls()
        cfg.enabled = (knobs.env_raw(TRACE_ENV) or "1").strip() not in ("0", "off", "false", "no")
        try:
            cfg.buffer = max(16, int(knobs.env_raw(TRACE_BUFFER_ENV, "")))
        except ValueError:
            cfg.buffer = _DEFAULT_BUFFER
        try:
            cfg.sample = min(1.0, max(0.0, float(knobs.env_raw(TRACE_SAMPLE_ENV, ""))))
        except ValueError:
            cfg.sample = 1.0
        cfg.dump_dir = knobs.env_raw(TRACE_DIR_ENV, "")
        return cfg


def step_sampled(step: int, sample: float) -> bool:
    """Whether ``step`` is traced at rate ``sample``: a Knuth multiplicative
    hash, so every replica keeps the same steps."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    return ((step * 2654435761) % (1 << 32)) / float(1 << 32) < sample


class _SpanHandle:
    """An open span; recorded when its ``with`` block exits."""

    __slots__ = ("_rec", "name", "cat", "args", "_t0_us", "_t0_pc")

    def __init__(self, rec: "SpanRecorder", name: str, cat: str, args: dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_SpanHandle":
        self._t0_us = self._rec._now_us()
        self._t0_pc = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        dur_us = int((time.perf_counter() - self._t0_pc) * 1e6)
        self._rec._append(self.name, self.cat, self._t0_us, max(dur_us, 1), self.args)


class SpanRecorder:
    """A bounded ring of spans of one replica. Thread-safe; every recording
    call is a no-op when disabled, so call sites never branch. Stamps are
    epoch microseconds of the local clock."""

    def __init__(self, replica_id: str, config: Optional[TraceConfig] = None) -> None:
        self._replica_id = replica_id
        self._config = config if config is not None else TraceConfig.from_env()
        self._spans: Deque[Dict[str, Any]] = deque(maxlen=self._config.buffer)
        self._lock = threading.Lock()
        self._quorum_id: Optional[int] = None
        self._step: Optional[int] = None
        self._step_on = True  # the sampling decision of the current step
        self._skew_ms = 0.0
        self._rtt_ms = 0.0
        self._skew_samples = 0
        self._dropped = 0
        self._recorded = 0

    @property
    def enabled(self) -> bool:
        return self._config.enabled

    @property
    def replica_id(self) -> str:
        return self._replica_id

    def set_context(self, quorum_id: Optional[int] = None, step: Optional[int] = None) -> None:
        """The ``(quorum_id, step)`` later spans carry; a new step takes its
        sampling decision."""
        with self._lock:
            if quorum_id is not None:
                self._quorum_id = quorum_id
            if step is not None and step != self._step:
                self._step = step
                self._step_on = step_sampled(step, self._config.sample)

    def set_skew(self, skew_ms: float, rtt_ms: float = 0.0, samples: int = 0) -> None:
        """The latest skew estimate from the heartbeats."""
        with self._lock:
            self._skew_ms = float(skew_ms)
            self._rtt_ms = float(rtt_ms)
            self._skew_samples = int(samples)

    def _now_us(self) -> int:
        return time.time_ns() // 1000 + int(_offset_ms_for(self._replica_id) * 1000)

    def _append(self, name: str, cat: str, ts_us: int, dur_us: int, args: dict) -> None:
        if not self._config.enabled:
            return
        with self._lock:
            if not self._step_on:
                return
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._recorded += 1
            span: Dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ts_us": ts_us,
                "dur_us": dur_us,
                "quorum_id": self._quorum_id,
                "step": self._step,
            }
            if args:
                span["args"] = args
            self._spans.append(span)

    def span(self, name: str, cat: str = "step", **args: Any) -> _SpanHandle:
        """``with tracer.span("quorum_rpc", cat="quorum"): ...``"""
        return _SpanHandle(self, name, cat, args)

    def record(self, name: str, cat: str, t0_us: int, t1_us: int, **args: Any) -> None:
        """A finished interval between two epoch-microsecond stamps."""
        self._append(name, cat, int(t0_us), max(int(t1_us - t0_us), 1), args)

    def record_rel(self, name: str, cat: str, t0_pc: float, t1_pc: float, **args: Any) -> None:
        """A finished interval between two ``time.perf_counter()`` marks,
        anchored to the wall clock now."""
        anchor_us = self._now_us()
        anchor_pc = time.perf_counter()
        t0_us = anchor_us + int((t0_pc - anchor_pc) * 1e6)
        t1_us = anchor_us + int((t1_pc - anchor_pc) * 1e6)
        self._append(name, cat, t0_us, max(t1_us - t0_us, 1), args)

    def instant(self, name: str, cat: str, **args: Any) -> None:
        """A zero-length marker (a retry, a re-route, a health transition)."""
        self._append(name, cat, self._now_us(), 1, args)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "spans": float(len(self._spans)),
                "recorded": float(self._recorded),
                "dropped": float(self._dropped),
            }

    def export(self) -> Dict[str, Any]:
        """This replica's dump, ready to merge."""
        with self._lock:
            return {
                "replica_id": self._replica_id,
                "clock": "epoch_us",
                "skew_ms": self._skew_ms + _offset_ms_for(self._replica_id),
                "rtt_ms": self._rtt_ms,
                "skew_samples": self._skew_samples,
                "dropped": self._dropped,
                "spans": list(self._spans),
            }

    def dump(self, path: "str | Path | None" = None) -> Optional[Path]:
        """Write ``export()`` as JSON and return the path: ``path``, else a
        new file in ``TORCHFT_TRACE_DIR``, else in ``{TORCHFT_FR_BASE_PATH}
        _traces``, else None. Never raises (dumps run on failure paths)."""
        try:
            if path is None:
                base = self._config.dump_dir or knobs.env_raw("TORCHFT_FR_BASE_PATH", "")
                if not base:
                    return None
                d = Path(base) if self._config.dump_dir else Path(str(base) + "_traces")
                d.mkdir(parents=True, exist_ok=True)
                path = d / f"trace_{self._replica_id}_{time.time_ns()}.json"
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                json.dump(self.export(), f)
            return path
        except Exception:  # noqa: BLE001 - observability never raises
            return None


def merge_traces(dumps: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """N replicas' dumps as one Chrome-trace dict: a process per replica
    (pids in replica id order, labelled with the skew applied), a thread
    per span category, every stamp moved by ``-skew_ms`` onto the
    lighthouse's clock."""
    events: List[Dict[str, Any]] = []
    ordered = sorted(dumps, key=lambda d: str(d.get("replica_id", "")))
    for pid, dump in enumerate(ordered):
        rid = str(dump.get("replica_id", f"replica_{pid}"))
        skew_us = float(dump.get("skew_ms", 0.0)) * 1000.0
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{rid} (skew {dump.get('skew_ms', 0.0):+.3f}ms)"},
        })
        tids: Dict[str, int] = {}
        for span in dump.get("spans", []):
            cat = str(span.get("cat", "step"))
            tid = tids.setdefault(cat, len(tids))
            args = dict(span.get("args", {}))
            args["quorum_id"] = span.get("quorum_id")
            args["step"] = span.get("step")
            args["replica_id"] = rid
            events.append({
                "name": str(span.get("name", "?")),
                "cat": cat,
                "ph": "X",
                "ts": float(span.get("ts_us", 0)) - skew_us,
                "dur": max(float(span.get("dur_us", 1)), 1.0),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
        for cat, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                           "args": {"name": cat}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def parse_history(text: str) -> List[Dict[str, Any]]:
    """Recorded-history JSONL content as a list of events, blank lines
    skipped."""
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def load_history(source: str) -> List[Dict[str, Any]]:
    """A history's events from a path to a ``--history`` JSONL file (plain
    or gzipped, told by its magic bytes) or from the JSONL content itself.
    The ``trace history`` CLI and ``coordination.history_replay`` both read
    through here."""
    if "\n" not in source and os.path.exists(source):
        with open(source, "rb") as f:
            blob = f.read()
        if blob[:2] == b"\x1f\x8b":
            blob = gzip.decompress(blob)
        return parse_history(blob.decode("utf-8"))
    return parse_history(source)


def history_fold(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The summary of a history, field for field the native fold's
    (``native/history.cc``, ``coordination.history_replay``)."""
    kinds: Dict[str, int] = {}
    replicas = set()
    count = 0
    last_quorum_id = -1
    max_step = -1
    first_ts = -1
    last_ts = -1
    for e in events:
        count += 1
        kind = str(e.get("kind", "unknown"))
        kinds[kind] = kinds.get(kind, 0) + 1
        if "replica_id" in e:
            replicas.add(str(e["replica_id"]))
        for rid in e.get("participants", []):
            replicas.add(str(rid))
        if "quorum_id" in e:
            last_quorum_id = int(e["quorum_id"])
        if "step" in e:
            max_step = max(max_step, int(e["step"]))
        if "to_step" in e:
            max_step = max(max_step, int(e["to_step"]))
        if "ts_ms" in e:
            ts = int(e["ts_ms"])
            if first_ts < 0:
                first_ts = ts
            last_ts = ts
    return {
        "count": count,
        "kinds": kinds,
        "replicas": sorted(replicas),
        "quorum_transitions": kinds.get("quorum", 0),
        "last_quorum_id": last_quorum_id,
        "heals": kinds.get("heal", 0),
        "ejections": kinds.get("eject", 0),
        "readmissions": kinds.get("readmit", 0),
        "warns": kinds.get("straggler_warn", 0),
        "max_step": max_step,
        "first_ts_ms": first_ts,
        "last_ts_ms": last_ts,
    }
