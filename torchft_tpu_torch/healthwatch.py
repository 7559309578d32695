"""Healthwatch: straggler scoring and the escalation policy of the health
plane.

Counterpart of ``torchft_tpu/healthwatch.py``. The quorum's liveness test
is binary (a heartbeat is fresh or stale), so a slow but live replica holds
every synchronous step back: the managed allreduce is a barrier. Healthwatch
turns per-step telemetry into membership decisions:

1. The group leader's Manager publishes each step's telemetry (``step``,
   ``step_s``, ``wire_s``, heal and retry counters) on its heartbeat.
2. The lighthouse's native ledger (``native/healthwatch.cc``) keeps a
   window of compute-time samples (``step_s - wire_s``) per replica and
   scores each against the quorum (``straggler_scores``).
3. ``ok -> warn -> ejected -> probation -> ok`` (``HealthLedger``): an
   ejected replica is left out of the next quorum, a step-granular
   membership change through the shrink path, and readmitted after a
   probation of continuous fresh beats.
4. A replica reporting a reduced ``group_world_size`` is ``DEGRADED``: its
   samples are scaled to full capacity, it never takes a strike, it drains
   from serving, and full degree restores it to OK.

This module is the specification the native ledger mirrors; the tests
drive the same inputs through both (``coordination.health_scores`` and
``coordination.health_replay``).

Scoring: per replica the median of its window; across replicas a modified
z-score ``(x - median) / scale`` with ``scale`` the MAD over 0.6745,
floored at ``rel_floor * median`` (on a homogeneous fleet the MAD is 0).
Only a slow replica scores. Fewer than two scorable replicas: all zero, so
fleets of one or two never reach a threshold.

Knobs (``TORCHFT_HEALTH_*``, ``HealthConfig.from_env``): ``MODE``
(``off`` | ``observe``, the default: score and report | ``eject``),
``WINDOW`` 32, ``MIN_SAMPLES`` 5, ``WARN_Z`` 3.0, ``EJECT_Z`` 6.0,
``EJECT_STEPS`` 3, ``PROBATION_MS`` 10000, ``PROBE_OK`` 3, ``REL_FLOOR``
0.05.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from torchft_tpu_torch import knobs

__all__ = [
    "HealthConfig",
    "HealthState",
    "HealthLedger",
    "median",
    "mad",
    "straggler_scores",
    "serving_eligible",
    "spare_eligible",
    "history_script",
]

_MODES = ("off", "observe", "eject")


@dataclass(frozen=True)
class HealthConfig:
    """The healthwatch policy's knobs (module docstring)."""

    mode: str = "observe"
    window: int = 32
    min_samples: int = 5
    warn_z: float = 3.0
    eject_z: float = 6.0
    eject_steps: int = 3
    probation_ms: int = 10000
    probe_ok: int = 3
    rel_floor: float = 0.05

    @staticmethod
    def from_env() -> "HealthConfig":
        """From ``TORCHFT_HEALTH_*``; ``ValueError`` naming the variable on
        a value that does not parse or validate."""
        defaults = HealthConfig()

        def get(name: str, cast: Any, default: Any) -> Any:
            raw = knobs.env_raw(name)
            if raw is None or raw == "":
                return default
            try:
                return cast(raw)
            except (TypeError, ValueError) as e:
                raise ValueError(f"{name}={raw!r}: {e}") from e

        cfg = HealthConfig(
            mode=get("TORCHFT_HEALTH_MODE", str, defaults.mode).lower(),
            window=get("TORCHFT_HEALTH_WINDOW", int, defaults.window),
            min_samples=get("TORCHFT_HEALTH_MIN_SAMPLES", int, defaults.min_samples),
            warn_z=get("TORCHFT_HEALTH_WARN_Z", float, defaults.warn_z),
            eject_z=get("TORCHFT_HEALTH_EJECT_Z", float, defaults.eject_z),
            eject_steps=get("TORCHFT_HEALTH_EJECT_STEPS", int, defaults.eject_steps),
            probation_ms=get("TORCHFT_HEALTH_PROBATION_MS", int, defaults.probation_ms),
            probe_ok=get("TORCHFT_HEALTH_PROBE_OK", int, defaults.probe_ok),
            rel_floor=get("TORCHFT_HEALTH_REL_FLOOR", float, defaults.rel_floor),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"TORCHFT_HEALTH_MODE={self.mode!r}: must be one of {_MODES}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {self.min_samples}")
        if self.eject_z <= self.warn_z:
            raise ValueError(f"eject_z ({self.eject_z}) must be > warn_z ({self.warn_z}): an "
                             "eject threshold at or below warn skips the warning")
        if self.eject_steps < 1:
            raise ValueError(f"eject_steps must be >= 1, got {self.eject_steps}")
        if self.probation_ms < 0:
            raise ValueError(f"probation_ms must be >= 0, got {self.probation_ms}")
        if self.rel_floor <= 0:
            raise ValueError(f"rel_floor must be > 0, got {self.rel_floor}")

    def to_json(self) -> Dict[str, Any]:
        """The ``health`` options object of the native lighthouse."""
        return {
            "mode": self.mode,
            "window": self.window,
            "min_samples": self.min_samples,
            "warn_z": self.warn_z,
            "eject_z": self.eject_z,
            "eject_steps": self.eject_steps,
            "probation_ms": self.probation_ms,
            "probe_ok": self.probe_ok,
            "rel_floor": self.rel_floor,
        }


def median(values: Sequence[float]) -> float:
    """The median; 0.0 for no values (as the native ledger)."""
    if not values:
        return 0.0
    v = sorted(values)
    n = len(v)
    if n % 2 == 1:
        return float(v[n // 2])
    return 0.5 * (v[n // 2 - 1] + v[n // 2])


def mad(values: Sequence[float]) -> float:
    """The median absolute deviation around the median."""
    m = median(values)
    return median([abs(x - m) for x in values])


def straggler_scores(
    windows: Mapping[str, Sequence[float]], config: HealthConfig
) -> Dict[str, float]:
    """Each replica's score against the quorum. ``windows`` maps a replica
    to its window of compute-time samples; one with fewer than
    ``min_samples`` is in its warm-up: scored 0 and left out of the peer
    statistics. Fewer than two scorable replicas: all zero."""
    scores: Dict[str, float] = {rid: 0.0 for rid in windows}
    stats = {rid: median(w) for rid, w in windows.items() if len(w) >= config.min_samples}
    if len(stats) < 2:
        return scores
    xs = list(stats.values())
    med = median(xs)
    scale = max(mad(xs) / 0.6745, config.rel_floor * max(med, 0.0), 1e-9)
    for rid, x in stats.items():
        scores[rid] = max(0.0, x - med) / scale  # only a slow replica scores
    return scores


class HealthState(IntEnum):
    OK = 0
    WARN = 1
    EJECTED = 2
    PROBATION = 3
    # between OK and WARN by severity, but after the others: the codes
    # 0..3 are pinned by the native ledger, timings()'s health_state and
    # /metrics
    DEGRADED = 4


# the serving plane's drain policy: which states take a replica out of
# the serving set. "warn" drains at the first warning, before the ejection
# takes it out of training; "eject" only once ejected. DEGRADED drains
# under both: its spare cycles belong to catching up
SERVE_DRAIN_STATES: Dict[str, Tuple[HealthState, ...]] = {
    "warn": (HealthState.WARN, HealthState.EJECTED, HealthState.PROBATION,
             HealthState.DEGRADED),
    "eject": (HealthState.EJECTED, HealthState.DEGRADED),
}

_STATE_NAMES = {
    "ok": HealthState.OK,
    "warn": HealthState.WARN,
    "ejected": HealthState.EJECTED,
    "probation": HealthState.PROBATION,
    "degraded": HealthState.DEGRADED,
}


def _parse_state(state: "HealthState | int | str") -> Optional[HealthState]:
    """The native ``/health`` state string, the enum or its code; None for
    what is none of them."""
    if isinstance(state, str):
        parsed = _STATE_NAMES.get(state.strip().lower())
        if parsed is None:
            return None
        state = parsed
    try:
        return HealthState(int(state))
    except (ValueError, TypeError):
        return None


def serving_eligible(state: "HealthState | int | str", drain_on: str = "warn") -> bool:
    """True when a replica in ``state`` may serve inference traffic under
    the ``drain_on`` policy. An unknown state is not eligible: fail toward
    draining."""
    if drain_on not in SERVE_DRAIN_STATES:
        raise ValueError(f"drain_on must be one of {tuple(SERVE_DRAIN_STATES)}, got {drain_on!r}")
    parsed = _parse_state(state)
    return parsed is not None and parsed not in SERVE_DRAIN_STATES[drain_on]


def spare_eligible(state: "HealthState | int | str") -> bool:
    """True when a hot spare in ``state`` may be promoted into the quorum:
    only a clean OK (a sick spare would trade a dead member for a
    straggler). A spare the ledger never saw reports "ok"; an unknown state
    string is not eligible."""
    return _parse_state(state) == HealthState.OK


@dataclass
class _Replica:
    window: List[float] = field(default_factory=list)
    last_step: int = -1
    last_step_s: float = 0.0
    last_wire_s: float = 0.0
    score: float = 0.0
    state: HealthState = HealthState.OK
    strikes: int = 0
    probes_ok: int = 0
    ejections: int = 0
    readmissions: int = 0
    samples_total: int = 0
    ejected_at_ms: float = 0.0
    last_beat_ms: Optional[float] = None
    # the degrade plane: the last reported group degree (0: never)
    group_world_size: int = 0
    full_group_world_size: int = 0


class HealthLedger:
    """The Python mirror of the native ledger. Time is an explicit
    ``now_ms`` so tests replay scripts; ``coordination.health_replay``
    drives the native ledger through the same script."""

    def __init__(
        self, config: HealthConfig, heartbeat_timeout_ms: int = 5000, min_replicas: int = 1
    ) -> None:
        self.config = config
        self.heartbeat_timeout_ms = heartbeat_timeout_ms
        self.min_replicas = min_replicas
        self._replicas: Dict[str, _Replica] = {}
        self._excluded: set = set()

    @property
    def exclusions(self) -> "set[str]":
        return set(self._excluded)

    def on_heartbeat(
        self, replica_id: str, telemetry: Optional[Mapping[str, Any]], now_ms: float
    ) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        if self.config.mode == "off":
            return events
        rh = self._replicas.setdefault(replica_id, _Replica())
        # probation wants continuous fresh beats: a gap restarts its clock
        if (rh.state is HealthState.EJECTED and rh.last_beat_ms is not None
                and now_ms - rh.last_beat_ms > self.heartbeat_timeout_ms):
            rh.ejected_at_ms = now_ms
        rh.last_beat_ms = now_ms

        if telemetry is None or "step" not in telemetry or rh.state is HealthState.EJECTED:
            return events
        step = int(telemetry["step"])
        if step <= rh.last_step:  # the beat loop re-sends the latest
            return events
        rh.last_step = step
        step_s = float(telemetry.get("step_s", 0.0))
        wire_s = float(telemetry.get("wire_s", 0.0))
        rh.last_step_s = step_s
        rh.last_wire_s = wire_s
        sample = max(step_s - wire_s, 0.0)
        # a replica at reduced group degree is scored against what a step
        # should cost at full capacity, never struck for being slower
        gws = telemetry.get("group_world_size")
        full = telemetry.get("full_group_world_size")
        if gws is not None and full is not None:
            gws, full = int(gws), int(full)
            rh.group_world_size = gws
            rh.full_group_world_size = full
            if 0 < gws < full:
                sample *= gws / float(full)
                if rh.state in (HealthState.OK, HealthState.WARN):
                    rh.state = HealthState.DEGRADED
                    rh.strikes = 0
                    events.append({"kind": "degrade", "replica_id": replica_id,
                                   "group_world_size": gws, "full_group_world_size": full})
            elif rh.state is HealthState.DEGRADED and full > 0 and gws >= full:
                rh.state = HealthState.OK
                events.append({"kind": "restore", "replica_id": replica_id,
                               "group_world_size": gws})
        rh.window.append(sample)
        del rh.window[: -self.config.window]
        rh.samples_total += 1
        self._evaluate(replica_id, now_ms, events)
        return events

    def tick(self, now_ms: float, prune_after_ms: Optional[int] = None) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        if self.config.mode == "off":
            return events
        prune = prune_after_ms if prune_after_ms is not None else 10 * self.heartbeat_timeout_ms
        for rid in list(self._replicas):
            rh = self._replicas[rid]
            beat = rh.last_beat_ms if rh.last_beat_ms is not None else -prune
            if now_ms - beat > prune:
                self._excluded.discard(rid)
                del self._replicas[rid]
                continue
            if (rh.state is HealthState.EJECTED
                    and now_ms - rh.ejected_at_ms >= self.config.probation_ms
                    and now_ms - beat < self.heartbeat_timeout_ms):
                rh.state = HealthState.PROBATION
                rh.readmissions += 1
                rh.probes_ok = 0
                self._excluded.discard(rid)
                events.append({"kind": "readmit", "replica_id": rid,
                               "readmissions": rh.readmissions})
        return events

    def state_of(self, replica_id: str) -> HealthState:
        rh = self._replicas.get(replica_id)
        return rh.state if rh else HealthState.OK

    def replica(self, replica_id: str) -> Optional[_Replica]:
        return self._replicas.get(replica_id)

    def _can_eject(self, now_ms: float) -> bool:
        live = sum(
            1 for rid, rh in self._replicas.items()
            if rid not in self._excluded and rh.last_beat_ms is not None
            and now_ms - rh.last_beat_ms < self.heartbeat_timeout_ms
        )
        return live - 1 >= self.min_replicas

    def _eject(self, rid: str, rh: _Replica, now_ms: float, events: List[Dict]) -> None:
        rh.state = HealthState.EJECTED
        rh.ejections += 1
        rh.strikes = 0
        rh.probes_ok = 0
        rh.ejected_at_ms = now_ms
        # last_step stays: the beat loop re-sends the last telemetry from
        # before the ejection until the replica steps again
        rh.window = []
        self._excluded.add(rid)
        events.append({"kind": "eject", "replica_id": rid, "score": rh.score,
                       "ejections": rh.ejections})

    def _evaluate(self, rid: str, now_ms: float, events: List[Dict]) -> None:
        cfg = self.config
        windows = {r: rh.window for r, rh in self._replicas.items() if r not in self._excluded}
        scores = straggler_scores(windows, cfg)
        for r, rh in self._replicas.items():
            if r in scores:
                rh.score = scores[r]
        rh = self._replicas[rid]
        s = rh.score

        if rh.state is HealthState.DEGRADED:
            # its samples keep the peer statistics honest, but it is slow by
            # declaration: no strike, no warning
            rh.strikes = 0
            return

        if rh.state is HealthState.PROBATION:
            if s > cfg.eject_z:  # one strike in probation: straight back out
                if cfg.mode == "eject" and self._can_eject(now_ms):
                    self._eject(rid, rh, now_ms, events)
                return
            if len(rh.window) < cfg.min_samples:
                return  # warm-up samples say nothing about recovery
            rh.probes_ok += 1
            if rh.probes_ok >= cfg.probe_ok:
                rh.state = HealthState.WARN if s > cfg.warn_z else HealthState.OK
                rh.probes_ok = 0
            return

        rh.strikes = rh.strikes + 1 if s > cfg.eject_z else 0
        if s > cfg.warn_z and rh.state is HealthState.OK:
            rh.state = HealthState.WARN
            events.append({"kind": "straggler_warn", "replica_id": rid, "score": s,
                           "warn_z": cfg.warn_z})
        elif s <= cfg.warn_z and rh.state is HealthState.WARN:
            rh.state = HealthState.OK

        if rh.strikes >= cfg.eject_steps:
            if cfg.mode == "eject" and self._can_eject(now_ms):
                self._eject(rid, rh, now_ms, events)
            else:
                events.append({
                    "kind": "straggler_warn", "replica_id": rid, "score": s,
                    "would_eject": True,
                    "reason": "min_replicas floor" if cfg.mode == "eject" else f"mode={cfg.mode}",
                })
                rh.strikes = 0


def history_script(events: Sequence[Mapping[str, Any]], beat_ms: float = 100.0) -> List[Dict[str, Any]]:
    """A beat/tick script, for ``HealthLedger`` or
    ``coordination.health_replay``, from a lighthouse's recorded history
    (``tracing.load_history``): each telemetry snapshot a beat at its time,
    keep-alive beats of every replica the history names every ``beat_ms``
    (the Managers' heartbeat) between them, and a tick after each."""
    telemetry = [e for e in events if e.get("kind") == "telemetry"]
    if not telemetry:
        return []
    replicas = sorted({str(e["replica_id"]) for e in telemetry})
    script: List[Dict[str, Any]] = []
    t = telemetry[0]["ts_ms"]
    for e in telemetry:
        while t + beat_ms < e["ts_ms"]:
            t += beat_ms
            script += [{"t_ms": t, "replica_id": rid} for rid in replicas]
            script.append({"t_ms": t, "tick": True})
        script.append({"t_ms": e["ts_ms"], "replica_id": e["replica_id"],
                       "telemetry": e["telemetry"]})
        script.append({"t_ms": e["ts_ms"], "tick": True})
    return script
