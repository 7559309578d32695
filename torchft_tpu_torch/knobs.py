"""The knob registry: every ``TORCHFT_*`` environment variable the port
reads, declared once, and the only module that reads them.

Counterpart of ``torchft_tpu/knobs.py``. ``REGISTRY`` maps each name to
its ``Knob``: type, default, where the port documents it (``doc``: the
README's knob table), the doctor check that validates it (``doctor``,
``python -m torchft_tpu_torch.doctor``) and a one-line summary; type,
default, doctor check and summary are the reference's. It holds the
reference's knobs that the port reads and no other: the degrade plane's
join with its plane (``ROADMAP.md``), and the JAX package's scan and
Pallas tile knobs have no reader in the port. The XLA process group's two
(``TORCHFT_XLA_HEARTBEAT_SEC``, ``TORCHFT_HOST``) keep their names and
meanings for ``ProcessGroupDevice``: the env contract is shared.

Every read goes through ``env_raw`` or a typed reader (``env_str``,
``env_int``, ``env_float``, ``env_bool``), which raise ``KeyError`` on a
name the registry does not hold, so a misspelt knob fails in a test
instead of reading as unset. An unset or empty variable gives the
reader's default; a boolean is false for "0", "false", "no" or "off"
(any case) and true for any other value.

The override layer (``set_override``, ``get_overrides``,
``clear_overrides``, ``override_scope``) installs string values that
every read sees before the process environment. Overrides are
process-local, never touch ``os.environ``, nest, and can name only a
registered knob: an unregistered name raises ``KeyError`` before anything
changes. The module imports nothing but the standard library, so spawned
children and import-time reads pay nothing for it.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, TypeVar

__all__ = [
    "Knob", "REGISTRY", "is_registered", "all_knobs", "set_override", "get_overrides",
    "clear_overrides", "override_scope", "env_raw", "env_str", "env_int", "env_float",
    "env_bool",
]

T = TypeVar("T")

# where the port documents every registered knob
DOC = "README.md#knobs"


@dataclass(frozen=True)
class Knob:
    """One registered environment variable."""

    name: str  # the full TORCHFT_* name
    type: str  # "str" | "int" | "float" | "bool" | "enum(a|b|...)"
    default: str  # as an operator would write it ("" = unset)
    doc: str  # where the port documents it
    doctor: Optional[str]  # the doctor check that validates it, or None
    summary: str  # one line for an operator


def _k(name: str, type: str, default: str, doctor: Optional[str], summary: str) -> Knob:
    return Knob(name, type, default, DOC, doctor, summary)


REGISTRY: Dict[str, Knob] = {
    k.name: k
    for k in [
        # the control plane
        _k("TORCHFT_LIGHTHOUSE", "str", "", "aggregator",
           "Root lighthouse address (host:port) managers coordinate through."),
        _k("TORCHFT_LIGHTHOUSE_AGGREGATOR", "str", "", "aggregator",
           "Pod-level lighthouse aggregator address; beats fail over to the root."),
        _k("TORCHFT_MANAGER_PORT", "int", "0", "tuning-env",
           "Bind port for the group-leader ManagerServer (0 = ephemeral)."),
        _k("TORCHFT_TIMEOUT_SEC", "float", "60", "retry-env",
           "Default control-plane RPC deadline in seconds."),
        _k("TORCHFT_QUORUM_TIMEOUT_SEC", "float", "60", "retry-env",
           "Quorum formation deadline; retry backoff budgets are ordered below it."),
        _k("TORCHFT_CONNECT_TIMEOUT_SEC", "float", "10", "tuning-env",
           "TCP connect deadline for control-plane clients."),
        _k("TORCHFT_HOST", "str", "127.0.0.1", "tuning-env",
           "Hostname the XLA store/transport advertises (multi-host fleets)."),
        _k("TORCHFT_QUORUM_RETRIES", "int", "0", "tuning-env",
           "Consecutive quorum failures tolerated before the manager raises."),
        _k("TORCHFT_HEARTBEAT_INTERVAL_MS", "float", "100", "health-env",
           "Manager heartbeat cadence; health probation windows are sized against it."),
        # the data plane
        _k("TORCHFT_BUCKET_CAP_MB", "float", "32", "tuning-env",
           "Allreduce flat-bucket cap in MB; 0 disables bucketing."),
        _k("TORCHFT_STREAM_BUCKETS", "bool", "1", "compress-env",
           "Per-bucket streamed allreduce pipeline (off = serial collectives)."),
        _k("TORCHFT_COMPRESS", "enum(off|fp8|int8)", "off", "compress-env",
           "Wire codec for streamed buckets, with per-bucket error feedback."),
        _k("TORCHFT_STREAM_CHUNK_BYTES", "int", "1048576", "tuning-env",
           "Heal/checkpoint transport chunk size in bytes."),
        _k("TORCHFT_USE_BUCKETIZATION", "bool", "0", "tuning-env",
           "LocalSGD/DiLoCo fragment bucketization toggle."),
        _k("TORCHFT_SYNC_EVERY", "int", "0", "policy-env",
           "LocalSGD/DiLoCo sync_every override (> 0 wins over the"
           " constructor argument; the policy plane retargets it live)."),
        # the retry policy
        _k("TORCHFT_RETRY_MAX_ATTEMPTS", "int", "3", "retry-env",
           "Control-plane RPC attempts before RetryBudgetExhausted."),
        _k("TORCHFT_RETRY_BASE_S", "float", "0.1", "retry-env",
           "First retry backoff in seconds (doubles per attempt)."),
        _k("TORCHFT_RETRY_MAX_BACKOFF_S", "float", "5", "retry-env",
           "Backoff ceiling; must stay below the quorum timeout."),
        _k("TORCHFT_RETRY_JITTER", "float", "0.5", "retry-env",
           "Backoff jitter fraction decorrelating retry herds."),
        # the health plane
        _k("TORCHFT_HEALTH_MODE", "enum(off|observe|eject)", "observe", "health-env",
           "Healthwatch escalation mode."),
        _k("TORCHFT_HEALTH_WINDOW", "int", "32", "health-env",
           "Rolling telemetry window per replica."),
        _k("TORCHFT_HEALTH_MIN_SAMPLES", "int", "5", "health-env",
           "Warmup samples before a replica is scored."),
        _k("TORCHFT_HEALTH_WARN_Z", "float", "3.0", "health-env",
           "Modified z-score that marks a straggler warn."),
        _k("TORCHFT_HEALTH_EJECT_Z", "float", "6.0", "health-env",
           "Modified z-score that counts an eject strike."),
        _k("TORCHFT_HEALTH_EJECT_STEPS", "int", "3", "health-env",
           "Consecutive strikes before proactive ejection."),
        _k("TORCHFT_HEALTH_PROBATION_MS", "int", "10000", "health-env",
           "Probationary readmission window after an eject."),
        _k("TORCHFT_HEALTH_PROBE_OK", "int", "3", "health-env",
           "Clean probation samples required for readmission."),
        _k("TORCHFT_HEALTH_REL_FLOOR", "float", "0.05", "health-env",
           "Relative slowdown floor below which z-scores never escalate."),
        # observability
        _k("TORCHFT_TRACE", "bool", "1", "trace-env",
           "Span recorder on/off (on by default, <1% overhead)."),
        _k("TORCHFT_TRACE_BUFFER", "int", "4096", "trace-env",
           "Span ring capacity (floor 16; overflow is counted)."),
        _k("TORCHFT_TRACE_SAMPLE", "float", "1.0", "trace-env",
           "Fraction of steps traced (deterministic by step hash)."),
        _k("TORCHFT_TRACE_DIR", "str", "", "trace-env",
           "Trace dump directory (empty = beside flight-recorder dumps)."),
        _k("TORCHFT_METRICS_PORT", "int", "", "tuning-env",
           "Manager-side Prometheus /metrics port (unset = not served)."),
        _k("TORCHFT_METRICS_PER_REPLICA_LIMIT", "int", "64", "tuning-env",
           "Per-replica series cap on the lighthouse /metrics exporter."),
        _k("TORCHFT_FR_BASE_PATH", "str", "", "tuning-env",
           "Flight-recorder dump directory (empty = temp dir)."),
        _k("TORCHFT_FR_CAPACITY", "int", "512", "tuning-env",
           "Flight-recorder ring capacity in events."),
        _k("TORCHFT_USE_OTEL", "bool", "0", "tuning-env",
           "Mirror structured events to an OTLP exporter when available."),
        _k("TORCHFT_OTEL_RESOURCE_ATTRIBUTES_JSON", "str", "", "tuning-env",
           "Extra OTLP resource attributes as a JSON object."),
        # the serving plane
        _k("TORCHFT_SERVE_REGISTRY", "str", "", "serve-env",
           "Snapshot-registry base URL; empty disables the plane."),
        _k("TORCHFT_SERVE_MAX_LAG", "int", "8", "serve-env",
           "Delta-ring depth; workers further behind full-pull."),
        _k("TORCHFT_SERVE_COMPRESS", "enum(off|fp8|int8)", "fp8", "serve-env",
           "Delta wire codec for published snapshots."),
        _k("TORCHFT_SERVE_POLL_S", "float", "0.05", "serve-env",
           "Worker poll interval in seconds."),
        _k("TORCHFT_SERVE_DRAIN_ON", "enum(warn|eject)", "warn", "serve-env",
           "Health state that drains a source from serve rotation."),
        _k("TORCHFT_SERVE_PORT", "int", "0", "serve-env",
           "Inference worker HTTP port (0 = ephemeral)."),
        _k("TORCHFT_SERVE_TIMEOUT_S", "float", "15", "serve-env",
           "Per-pull / per-RPC deadline on the serving plane."),
        # the redundancy plane
        _k("TORCHFT_REDUNDANCY_K", "int", "0", "redundancy-env",
           "Erasure data shards per generation; 0 = plane off."),
        _k("TORCHFT_REDUNDANCY_M", "int", "1", "redundancy-env",
           "Erasure parity shards per generation."),
        _k("TORCHFT_REDUNDANCY_DIRECTORY", "str", "", "redundancy-env",
           "ShardDirectory base URL (lighthouse --redundancy-directory)."),
        _k("TORCHFT_REDUNDANCY_INTERVAL", "int", "1", "redundancy-env",
           "Stage shards every N committed generations."),
        _k("TORCHFT_REDUNDANCY_TIMEOUT_S", "float", "15", "redundancy-env",
           "Per shard-RPC deadline."),
        _k("TORCHFT_REDUNDANCY_RETAIN", "int", "2", "redundancy-env",
           "Shard generations retained per owner in each store."),
        _k("TORCHFT_POD", "str", "", "tuning-env",
           "Placement pod identity (defaults to the aggregator-derived pod)."),
        # the policy plane
        _k("TORCHFT_POLICY", "enum(off|observe|enforce)", "off", "policy-env",
           "Adaptive policy engine mode: off = byte-identical legacy"
           " behavior, observe = log would-be actions, enforce = apply."),
        _k("TORCHFT_POLICY_SPEC", "str", "builtin", "policy-env",
           "PolicySpec source: 'builtin' or a path to a PolicySpec JSON."),
        _k("TORCHFT_POLICY_INTERVAL_S", "float", "5", "policy-env",
           "Engine evaluation cadence in seconds (fold + rule pass)."),
        _k("TORCHFT_POLICY_WINDOW_S", "float", "300", "policy-env",
           "Rolling window the fleet signals (MTBF, churn, ...) cover."),
        _k("TORCHFT_POLICY_RING", "int", "4096", "policy-env",
           "Lighthouse in-memory event-ring capacity feeding the engine."),
        # the device plane (process_group_device.py)
        _k("TORCHFT_XLA_HEARTBEAT_SEC", "float", "10", "tuning-env",
           "XLA process-group peer heartbeat timeout."),
        # the device
        _k("TORCHFT_WATCHDOG_TIMEOUT_SEC", "float", "30", "tuning-env",
           "Future-watchdog deadline that converts a wedged wait into an error."),
        _k("TORCHFT_TPU_ATTENTION", "enum(auto|splash|flash|reference)", "auto", None,
           "Attention kernel selector."),
    ]
}


def is_registered(name: str) -> bool:
    return name in REGISTRY


def all_knobs() -> Dict[str, Knob]:
    """A copy of the registry (name -> Knob)."""
    return dict(REGISTRY)


# replaced whole under _overrides_mu, never mutated: a read takes the
# current dict without the lock (the knobs are read on hot paths, such as
# every attention call) and never sees a scope half installed
_overrides: Dict[str, str] = {}
_overrides_mu = threading.Lock()


def _check_registered(name: str) -> None:
    if name not in REGISTRY:
        raise KeyError(f"{name} is not in the TORCHFT knob registry (torchft_tpu_torch/knobs.py "
                       "REGISTRY): register it with its type, default, doc and doctor check "
                       "before reading or overriding it")


def set_override(name: str, value: Optional[str]) -> None:
    """Install an override of a registered knob, or clear it with None.
    Values are strings, as an environment variable carries them."""
    global _overrides
    _check_registered(name)
    with _overrides_mu:
        new = dict(_overrides)
        if value is None:
            new.pop(name, None)
        else:
            new[name] = str(value)
        _overrides = new


def get_overrides() -> Dict[str, str]:
    """The active overrides (name -> value), a copy."""
    return dict(_overrides)


def clear_overrides() -> None:
    """Drop every active override."""
    global _overrides
    with _overrides_mu:
        _overrides = {}


@contextlib.contextmanager
def override_scope(values: Dict[str, str]) -> Iterator[None]:
    """Install ``values`` on entry and restore the overrides as they were
    on exit; an inner scope wins while it is active. Every name is checked
    before anything changes."""
    global _overrides
    for name in values:
        _check_registered(name)
    with _overrides_mu:
        saved = _overrides
        _overrides = {**saved, **{k: str(v) for k, v in values.items()}}
    try:
        yield
    finally:
        with _overrides_mu:
            _overrides = saved


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's override, else ``os.environ.get(name, default)``;
    ``KeyError`` for a name the registry does not hold."""
    _check_registered(name)
    value = _overrides.get(name)
    return value if value is not None else os.environ.get(name, default)


def _typed(name: str, default: T, cast: Callable[[str], T]) -> T:
    raw = env_raw(name)
    if raw is None or raw == "":
        return default
    return cast(raw)


def env_str(name: str, default: str = "") -> str:
    return _typed(name, default, str)


def env_int(name: str, default: int = 0) -> int:
    return _typed(name, default, int)


def env_float(name: str, default: float = 0.0) -> float:
    return _typed(name, default, float)


def env_bool(name: str, default: bool = False) -> bool:
    raw = env_raw(name)
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")
