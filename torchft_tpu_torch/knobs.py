"""Environment knobs: the port's copy of the reference's typed readers
(``torchft_tpu/knobs.py:334-346``) and of its gated raw reader ``env_raw``
(``:306``). An unset or empty variable gives the default; a boolean is
false for "0", "false", "no" or "off" (any case) and true for any other
value.

``env_raw`` reads only the names registered in ``REGISTRY`` and raises
``KeyError`` on any other, so a misspelt knob fails in a test instead of
being read as unset. The registry holds the names the observability and
health planes read: the healthwatch policy (``TORCHFT_HEALTH_*``), the span
recorder (``TORCHFT_TRACE*``), the flight recorder's capacity and dump
path, the Manager's ``/metrics`` port, the optional OpenTelemetry
mirror, and the serving plane's ``TORCHFT_SERVE_*`` contract. The reference's full registry (types, defaults, doc anchors,
doctor checks) and its policy overrides are not ported."""

from __future__ import annotations

import os
from typing import FrozenSet, Optional

__all__ = ["REGISTRY", "env_bool", "env_int", "env_raw"]

REGISTRY: FrozenSet[str] = frozenset({
    # healthwatch (healthwatch.py)
    "TORCHFT_HEALTH_MODE",
    "TORCHFT_HEALTH_WINDOW",
    "TORCHFT_HEALTH_MIN_SAMPLES",
    "TORCHFT_HEALTH_WARN_Z",
    "TORCHFT_HEALTH_EJECT_Z",
    "TORCHFT_HEALTH_EJECT_STEPS",
    "TORCHFT_HEALTH_PROBATION_MS",
    "TORCHFT_HEALTH_PROBE_OK",
    "TORCHFT_HEALTH_REL_FLOOR",
    # the span recorder (tracing.py)
    "TORCHFT_TRACE",
    "TORCHFT_TRACE_BUFFER",
    "TORCHFT_TRACE_SAMPLE",
    "TORCHFT_TRACE_DIR",
    # the flight recorder (flight_recorder.py)
    "TORCHFT_FR_BASE_PATH",
    "TORCHFT_FR_CAPACITY",
    # observability.py
    "TORCHFT_METRICS_PORT",
    "TORCHFT_USE_OTEL",
    "TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON",
    # the serving plane (serving.py)
    "TORCHFT_SERVE_REGISTRY",
    "TORCHFT_SERVE_MAX_LAG",
    "TORCHFT_SERVE_COMPRESS",
    "TORCHFT_SERVE_POLL_S",
    "TORCHFT_SERVE_DRAIN_ON",
    "TORCHFT_SERVE_PORT",
    "TORCHFT_SERVE_TIMEOUT_S",
})


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ.get`` of a registered knob; ``KeyError`` for a name the
    registry does not hold."""
    if name not in REGISTRY:
        raise KeyError(f"{name} is not a registered knob (torchft_tpu_torch/knobs.py REGISTRY)")
    return os.environ.get(name, default)


def env_int(name: str, default: int = 0) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return int(raw)


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")
