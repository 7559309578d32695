"""Observability, trimmed to the metrics registry the shard directory
renders at ``/metrics``.

Counterpart of ``torchft_tpu/observability.py``'s ``MetricsRegistry``
(``:343``): gauges, absolute counters and histograms, rendered as
Prometheus text exposition 0.0.4, byte for byte as the reference renders
them. The structured event streams, the trace spans and ``MetricsServer``
belong to the observability slice, listed in ROADMAP.md.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

__all__ = ["DEFAULT_TIME_BUCKETS", "MetricsRegistry"]

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
