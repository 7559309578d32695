"""The flight recorder: a ring of recent fault-tolerance events in memory,
written to disk when something fails (counterpart of
``torchft_tpu/flight_recorder.py``).

The Manager records cheap dict breadcrumbs into it (quorum reconfigures,
RPC retries, heal retries and failovers, chunk crc failures, re-routes,
healthwatch transitions, errors) and ``dump()``s it on a reported error, an
exhausted heal and an ejection, so a postmortem sees the sequence that led
there. One recorder serves the process (``recorder``); several Managers may
share it (replica threads), so a dump's identity is the caller's:
``dump(reason, quorum_id=..., tag=...)`` writes
``{TORCHFT_FR_BASE_PATH}_quorum_{quorum_id}/{tag}_{n}``, ``n`` counting this
recorder's dumps, so no dump overwrites another. Without
``TORCHFT_FR_BASE_PATH`` nothing is written. ``TORCHFT_FR_CAPACITY`` is the
ring's size in events (2048; at least 16). Thread-safe; recording does no
I/O.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, Optional

from torchft_tpu_torch import knobs

FR_BASE_PATH_ENV = "TORCHFT_FR_BASE_PATH"
FR_CAPACITY_ENV = "TORCHFT_FR_CAPACITY"

_DEFAULT_CAPACITY = 2048

__all__ = ["FlightRecorder", "recorder"]


def _env_capacity() -> int:
    try:
        return max(16, int(knobs.env_raw(FR_CAPACITY_ENV, "")))
    except ValueError:
        # a bad observability knob never stops training
        return _DEFAULT_CAPACITY


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None) -> None:
        cap = capacity if capacity is not None else _env_capacity()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=cap)
        self._lock = threading.Lock()
        self._seq = 0
        self._dump_seq = 0

    def record(self, kind: str, **fields: Any) -> None:
        with self._lock:
            self._seq += 1
            self._events.append({"seq": self._seq, "time": time.time(), "kind": kind, **fields})

    def dump_path(
        self, quorum_id: "int | str | None" = None, tag: Optional[str] = None
    ) -> Optional[Path]:
        base = knobs.env_raw(FR_BASE_PATH_ENV)
        if not base:
            return None
        qid = quorum_id if quorum_id is not None else "unknown"
        return Path(f"{base}_quorum_{qid}") / (tag or str(os.getpid()))

    def dump(
        self,
        reason: str = "abort",
        quorum_id: "int | str | None" = None,
        tag: Optional[str] = None,
    ) -> Optional[Path]:
        """Write the ring as JSON lines to ``{base}_quorum_{quorum_id}/
        {tag}_{n}`` (``tag`` defaults to the pid) and return the path; None
        when no base path is set. Never raises (dumps run on failure
        paths)."""
        try:
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = self.dump_path(quorum_id, f"{tag if tag is not None else os.getpid()}_{seq}")
            if path is None:
                return None
            self.record("dump", reason=reason)
            path.parent.mkdir(parents=True, exist_ok=True)
            with self._lock:
                events = list(self._events)
            with open(path, "w") as f:
                for e in events:
                    f.write(json.dumps(e, default=str) + "\n")
            return path
        except Exception:  # noqa: BLE001 - never raises
            return None


# the process's recorder, shared by every Manager and process group in it
recorder = FlightRecorder()
