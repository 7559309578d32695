"""The adaptive policy plane: rules over fleet signals that retune knobs live.

Counterpart of ``torchft_tpu/policy.py``. The fleet's signals (heartbeat
telemetry, health transitions, quorum churn, re-route and CRC counters)
all land in the lighthouse's recorded history; this module folds them and
turns them into knob overrides:

- ``fold_signals`` (reference ``:99``) folds history events into rolling
  fleet signals: MTBF, churn a minute, straggler density, link quality.
  It is event-time driven (``now_ms`` defaults to the newest event), and
  both the live engine (events drained from the lighthouse's ring) and
  the replay scorer (events read back from a ``--history`` file) fold
  through it, so a policy scored offline behaves the same online.
- ``PolicySpec`` (``:250``) is a rule set: signal, operator, threshold ->
  knob values, with a hysteresis band (a rule fires at ``threshold`` and
  releases only past ``release``) and per-knob min/max clamps. Every
  action and clamp names a knob of ``knobs.REGISTRY``.
- ``PolicyEngine`` (``:403``) evaluates a spec over the folded signals
  and emits versioned frames ``{"policy_seq", "mode", "knob_overrides",
  "active_rules"}``; ``policy_seq`` changes only when the override set
  does. The lighthouse publishes the newest frame on its heartbeat and
  ``agg_tick`` replies (no new RPC); each Manager reads it off its
  heartbeat mirror at its quorum safe point (``Manager.start_quorum``)
  and, in enforce mode, installs it through ``knobs.set_override``.
- ``PolicyController`` (``:494``) is the lighthouse's loop: drain the
  ring, evaluate, publish on a new seq and, in enforce mode, retune the
  health ledger (``_HEALTH_RETUNE``). A released rule reverts the
  Managers' overrides but not the ledger's retuned fields, as in the
  reference.
- ``python -m torchft_tpu_torch.policy replay --history FILE --policy
  A.json builtin [--window S] [--interval S] [--json]`` scores candidate
  specs against a recorded run (``score_policy``, ``rank_policies``):
  discarded steps, eject/readmit flapping, projected wire units and
  recovery exposure, lower is better.

Modes (``TORCHFT_POLICY``): ``off`` (default) runs nothing of the plane:
no ring, no frame, nothing polled; ``observe`` publishes frames and the
Managers record what they would do; ``enforce`` applies them.

Plain Python on the standard library and ``knobs``: the lighthouse CLI and
the doctor load it.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchft_tpu_torch import knobs

__all__ = [
    "Signals", "fold_signals", "PolicyRule", "PolicySpec", "PolicyEngine", "PolicyController",
    "builtin_spec", "score_policy", "rank_policies", "POLICY_MODES", "SIGNALS",
]

POLICY_MODES = ("off", "observe", "enforce")

# the signals a rule may condition on (the fold's fields)
SIGNALS = ("mtbf_s", "churn_per_min", "straggler_density", "link_quality")

# cumulative telemetry counters read as link faults (the fold takes each
# replica's deltas, so a re-sent payload costs nothing)
_LINK_FAULT_KEYS = ("collective_reroute", "chunk_crc_failures", "rpc_retries")


def _ts(e: Dict[str, Any], default: int = 0) -> int:
    return int(e.get("ts_ms", default))


def _order(e: Dict[str, Any]) -> Tuple[int, int]:
    return _ts(e), int(e.get("seq", 0))


# ---------------------------------------------------------------- signals
@dataclass
class Signals:
    """Rolling fleet signals folded from history events."""

    mtbf_s: float  # mean seconds between failures (the window's span if none)
    churn_per_min: float  # membership changes + ejects + readmits a minute
    straggler_density: float  # share of seen replicas warned or ejected
    link_quality: float  # 1 - link faults per telemetry step, floored at 0
    window_s: float  # the window the fold covered
    events: int  # events inside the window
    replicas: int  # distinct replicas seen inside the window
    failures: int  # ejects + quorum departures

    def to_dict(self) -> Dict[str, float]:
        return {
            "mtbf_s": round(self.mtbf_s, 3),
            "churn_per_min": round(self.churn_per_min, 4),
            "straggler_density": round(self.straggler_density, 4),
            "link_quality": round(self.link_quality, 4),
            "window_s": self.window_s,
            "events": self.events,
            "replicas": self.replicas,
            "failures": self.failures,
        }


def fold_signals(
    events: List[Dict[str, Any]], window_s: float, now_ms: Optional[int] = None
) -> Signals:
    """Fold history events into ``Signals`` over the ``window_s`` seconds
    up to ``now_ms`` (default: the newest event's ``ts_ms``, so the same
    events always fold the same, whatever the wall clock)."""
    if now_ms is None:
        now_ms = max((_ts(e) for e in events), default=0)
    lo_ms = now_ms - int(window_s * 1000.0)
    window = sorted((e for e in events if lo_ms <= _ts(e, now_ms) <= now_ms), key=_order)

    replicas = set()
    failure_ts: List[int] = []
    churn_units = 0
    flagged = set()  # replicas warned or ejected in the window
    prev_participants: Optional[set] = None
    last_counter: Dict[str, float] = {}  # each replica's last link-fault total
    fault_delta = 0.0
    telemetry_steps = 0
    for e in window:
        kind = str(e.get("kind", ""))
        ts = _ts(e, now_ms)
        rid = str(e.get("replica_id", "")) if "replica_id" in e else ""
        if rid:
            replicas.add(rid)
        if kind == "quorum":
            parts = {str(r) for r in e.get("participants", [])}
            replicas.update(parts)
            if prev_participants is not None:
                departed = prev_participants - parts
                churn_units += len(departed) + len(parts - prev_participants)
                failure_ts.extend(ts for _ in departed)
            prev_participants = parts
        elif kind == "eject":
            failure_ts.append(ts)
            churn_units += 1
            flagged.add(rid)
        elif kind == "readmit":
            churn_units += 1
        elif kind == "straggler_warn":
            flagged.add(rid)
        elif kind == "telemetry":
            telemetry_steps += 1
            t = e.get("telemetry", {}) or {}
            total = sum(float(t.get(k, 0.0)) for k in _LINK_FAULT_KEYS)
            prev = last_counter.get(rid)
            if prev is not None and total >= prev:  # a restart resets the counters
                fault_delta += total - prev
            last_counter[rid] = total

    span_s = max((now_ms - lo_ms) / 1000.0, 1e-9)
    n_failures = len(failure_ts)
    density = len(flagged) / len(replicas) if replicas else 0.0
    return Signals(
        mtbf_s=span_s / n_failures if n_failures > 0 else span_s,
        churn_per_min=churn_units / (span_s / 60.0),
        straggler_density=min(density, 1.0),
        link_quality=(max(0.0, 1.0 - fault_delta / telemetry_steps)
                      if telemetry_steps > 0 else 1.0),
        window_s=window_s,
        events=len(window),
        replicas=len(replicas),
        failures=n_failures,
    )


# ------------------------------------------------------------------- spec
_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}
# a rule releases under the flipped operator around its release bound
_FLIPPED = {"<": ">=", "<=": ">", ">": "<=", ">=": "<"}


@dataclass
class PolicyRule:
    """``signal op threshold`` -> knob actions. Once active the rule holds
    until the signal crosses ``release``, which lies on the far side of
    ``threshold``, so a signal hovering at the threshold cannot flap the
    fleet's knobs."""

    name: str
    signal: str
    op: str
    threshold: float
    release: float
    actions: Dict[str, str]

    def fires(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)

    def releases(self, value: float) -> bool:
        return _OPS[_FLIPPED[self.op]](value, self.release)

    def validate(self) -> None:
        if self.signal not in SIGNALS:
            raise ValueError(f"rule {self.name!r}: unknown signal {self.signal!r} "
                             f"(have {SIGNALS})")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        widened = (self.release <= self.threshold if self.op in (">", ">=")
                   else self.release >= self.threshold)
        if not widened:
            raise ValueError(f"rule {self.name!r}: release {self.release} must sit on the "
                             f"releasing side of threshold {self.threshold} for op {self.op!r} "
                             "(hysteresis band)")
        if not self.actions:
            raise ValueError(f"rule {self.name!r}: no actions")
        for knob in self.actions:
            if not knobs.is_registered(knob):
                raise ValueError(f"rule {self.name!r}: action targets unregistered knob "
                                 f"{knob!r}; register it in torchft_tpu_torch/knobs.py first")


@dataclass
class PolicySpec:
    """A named rule set with per-knob clamps. Rules are evaluated in order;
    when two active rules set one knob the later one wins. A clamp bounds
    every numeric value of its knob."""

    name: str
    rules: List[PolicyRule]
    clamps: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def validate(self) -> None:
        seen = set()
        for r in self.rules:
            if r.name in seen:
                raise ValueError(f"duplicate rule name {r.name!r}")
            seen.add(r.name)
            r.validate()
        for knob, (lo, hi) in self.clamps.items():
            if not knobs.is_registered(knob):
                raise ValueError(f"clamp targets unregistered knob {knob!r}")
            if lo > hi:
                raise ValueError(f"clamp for {knob!r}: min {lo} > max {hi}")

    def clamp(self, knob: str, value: str) -> str:
        """``value`` within the knob's clamp; a knob without one, or a value
        that is not a number (``TORCHFT_COMPRESS``'s), passes as it is."""
        if knob not in self.clamps:
            return value
        try:
            v = float(value)
        except ValueError:
            return value
        lo, hi = self.clamps[knob]
        clamped = min(max(v, lo), hi)
        if clamped == int(clamped) and "." not in value:
            return str(int(clamped))
        return str(clamped)

    @staticmethod
    def from_json(obj: Dict[str, Any]) -> "PolicySpec":
        rules = [
            PolicyRule(
                name=str(r["name"]), signal=str(r["signal"]), op=str(r["op"]),
                threshold=float(r["threshold"]), release=float(r["release"]),
                actions={str(k): str(v) for k, v in r["actions"].items()},
            )
            for r in obj.get("rules", [])
        ]
        clamps = {str(k): (float(v[0]), float(v[1])) for k, v in obj.get("clamps", {}).items()}
        spec = PolicySpec(name=str(obj.get("name", "unnamed")), rules=rules, clamps=clamps)
        spec.validate()
        return spec

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "rules": [{"name": r.name, "signal": r.signal, "op": r.op,
                       "threshold": r.threshold, "release": r.release,
                       "actions": dict(r.actions)} for r in self.rules],
            "clamps": {k: list(v) for k, v in self.clamps.items()},
        }

    @staticmethod
    def load(source: str) -> "PolicySpec":
        """The spec ``--policy PATH|builtin`` names."""
        if source == "builtin":
            return builtin_spec()
        with open(source) as f:
            return PolicySpec.from_json(json.load(f))


def builtin_spec() -> PolicySpec:
    """The default spec (reference ``:339-399``), wide bands:

    - calm: tighten the eject threshold (catch real stragglers);
    - churn: lengthen LocalSGD/DiLoCo's sync cadence and widen the eject
      threshold (a churning fleet misreads slowness);
    - flaky links: switch the wire codec to int8 (fewest bytes re-sent);
    - low MTBF: stage redundancy shards every commit, with a second parity
      shard.
    """
    return PolicySpec(
        name="builtin",
        rules=[
            PolicyRule(name="calm-tighten-eject", signal="churn_per_min", op="<",
                       threshold=0.5, release=2.0, actions={"TORCHFT_HEALTH_EJECT_Z": "5.0"}),
            PolicyRule(name="churn-lengthen-sync", signal="churn_per_min", op=">",
                       threshold=6.0, release=2.0,
                       actions={"TORCHFT_SYNC_EVERY": "64", "TORCHFT_HEALTH_EJECT_Z": "9.0"}),
            PolicyRule(name="flaky-links-compress", signal="link_quality", op="<",
                       threshold=0.9, release=0.97, actions={"TORCHFT_COMPRESS": "int8"}),
            PolicyRule(name="low-mtbf-stage-often", signal="mtbf_s", op="<",
                       threshold=120.0, release=300.0,
                       actions={"TORCHFT_REDUNDANCY_INTERVAL": "1",
                                "TORCHFT_REDUNDANCY_M": "2"}),
        ],
        clamps={
            "TORCHFT_SYNC_EVERY": (1, 512),
            "TORCHFT_HEALTH_EJECT_Z": (3.0, 12.0),
            "TORCHFT_REDUNDANCY_INTERVAL": (1, 64),
            "TORCHFT_REDUNDANCY_M": (1, 4),
        },
    )


# ----------------------------------------------------------------- engine
class PolicyEngine:
    """Folds events, evaluates a spec with hysteresis and emits versioned
    frames; the live controller and the replay scorer both run it."""

    def __init__(self, spec: PolicySpec, mode: str = "observe", window_s: float = 300.0) -> None:
        if mode not in POLICY_MODES:
            raise ValueError(f"mode {mode!r} not in {POLICY_MODES}")
        spec.validate()
        self.spec = spec
        self.mode = mode
        self.window_s = window_s
        self.policy_seq = 0
        self.active: List[str] = []  # active rule names, in spec order
        self._events: List[Dict[str, Any]] = []
        self._last_overrides: Dict[str, str] = {}
        self.flips = 0  # changes of the active set (flapping, for the scorer)

    def feed(self, events: List[Dict[str, Any]]) -> None:
        """Add drained events; evaluate prunes the old ones."""
        self._events.extend(events)

    def signals(self, now_ms: Optional[int] = None) -> Signals:
        return fold_signals(self._events, self.window_s, now_ms)

    def evaluate(self, now_ms: Optional[int] = None) -> Dict[str, Any]:
        """One pass: fold, update the rules' hysteresis, and return the
        frame. ``policy_seq`` moves only when the override set changes, so
        a steady fleet re-reads one frame, which the Managers dedup."""
        sig = fold_signals(self._events, self.window_s, now_ms)
        if self._events:
            # events older than two windows can reach no later fold
            horizon = max(_ts(e) for e in self._events) - int(self.window_s * 2000.0)
            self._events = [e for e in self._events if _ts(e, horizon) >= horizon]
        active = set(self.active)
        for rule in self.spec.rules:
            value = getattr(sig, rule.signal)
            if rule.name in active:
                if rule.releases(value):
                    active.discard(rule.name)
            elif rule.fires(value):
                active.add(rule.name)
        ordered = [r.name for r in self.spec.rules if r.name in active]
        if ordered != self.active:
            self.flips += 1
            self.active = ordered
        overrides: Dict[str, str] = {}
        for rule in self.spec.rules:
            if rule.name in active:
                for knob, value in rule.actions.items():
                    overrides[knob] = self.spec.clamp(knob, value)
        if overrides != self._last_overrides:
            self.policy_seq += 1
            self._last_overrides = overrides
        return self.frame()

    def frame(self) -> Dict[str, Any]:
        """The current frame, as ``LighthouseServer.set_policy`` publishes
        it."""
        return {
            "policy_seq": self.policy_seq,
            "mode": self.mode,
            "knob_overrides": dict(self._last_overrides),
            "active_rules": list(self.active),
        }


# ------------------------------------------------------------- controller
# the health ledger's fields an enforce frame retunes, by the knob naming them
_HEALTH_RETUNE = {
    "TORCHFT_HEALTH_EJECT_Z": ("eject_z", float),
    "TORCHFT_HEALTH_WARN_Z": ("warn_z", float),
    "TORCHFT_HEALTH_EJECT_STEPS": ("eject_steps", int),
}


class PolicyController:
    """The lighthouse's loop: drain the event ring, evaluate, publish. It
    takes callables, so tests drive it without a lighthouse;
    ``LighthouseServer`` wires in its ring, ``set_policy`` and
    ``retune_health`` and runs ``step`` every ``TORCHFT_POLICY_INTERVAL_S``.
    A frame is published only when its seq is new; in enforce mode the
    health fields the frame names are retuned on the ledger then."""

    def __init__(
        self,
        engine: PolicyEngine,
        drain_fn: Callable[[], List[Dict[str, Any]]],
        set_policy_fn: Callable[[Dict[str, Any]], None],
        retune_health_fn: Optional[Callable[[Dict[str, Any]], Any]] = None,
    ) -> None:
        self.engine = engine
        self._drain = drain_fn
        self._set_policy = set_policy_fn
        self._retune = retune_health_fn
        self._published_seq = -1

    def step(self, now_ms: Optional[int] = None) -> Dict[str, Any]:
        self.engine.feed(self._drain())
        frame = self.engine.evaluate(now_ms)
        if frame["policy_seq"] != self._published_seq:
            self._set_policy(frame)
            self._published_seq = frame["policy_seq"]
            if self.engine.mode == "enforce" and self._retune is not None:
                partial = {fld: cast(float(frame["knob_overrides"][knob]))
                           for knob, (fld, cast) in _HEALTH_RETUNE.items()
                           if knob in frame["knob_overrides"]}
                if partial:
                    self._retune(partial)
        return frame


# ---------------------------------------------------------------- scoring
# bytes on the wire against f32, by codec
_COMPRESS_FACTOR = {"off": 1.0, "fp8": 0.5, "int8": 0.25}
_DEFAULT_SYNC_EVERY = 32.0
# the components' weights in the score (lower is better)
_WEIGHTS = {
    "discarded_steps": 1.0,
    "flapping": 10.0,
    "projected_wire_units": 0.1,
    "recovery_exposure": 1.0,
}


def score_policy(
    events: List[Dict[str, Any]],
    spec: PolicySpec,
    window_s: float = 300.0,
    interval_s: float = 5.0,
) -> Dict[str, Any]:
    """Replay a recorded history through ``spec``: a ``PolicyEngine``
    stepped along event time every ``interval_s``. The components, each
    lower-is-better: ``discarded_steps`` (the heals' ``to_step -
    from_step``), ``flapping`` (eject/readmit pairs plus the engine's own
    flips), ``projected_wire_units`` (sync rounds under the spec's
    ``TORCHFT_SYNC_EVERY`` and codec) and ``recovery_exposure`` (failures x
    the sync cadence in force)."""
    engine = PolicyEngine(spec, mode="observe", window_s=window_s)
    ordered = sorted(events, key=_order)
    interval_ms = max(int(interval_s * 1000.0), 1)

    discarded = 0
    flap_pairs = 0
    ejected_at: Dict[str, int] = {}
    wire_units = 0.0
    exposure = 0.0
    telemetry_steps = 0
    # the knobs in force between evaluations
    sync_every = _DEFAULT_SYNC_EVERY
    wire_factor = _COMPRESS_FACTOR["off"]
    next_eval: Optional[int] = None
    for e in ordered:
        ts = _ts(e)
        if next_eval is None:
            next_eval = ts + interval_ms
        while ts >= next_eval:
            ov = engine.evaluate(next_eval)["knob_overrides"]
            sync_every = float(ov.get("TORCHFT_SYNC_EVERY", _DEFAULT_SYNC_EVERY))
            wire_factor = _COMPRESS_FACTOR.get(ov.get("TORCHFT_COMPRESS", "off"), 1.0)
            next_eval += interval_ms
        engine.feed([e])
        kind = str(e.get("kind", ""))
        if kind == "heal":
            discarded += max(int(e.get("to_step", 0)) - int(e.get("from_step", 0)), 0)
        elif kind == "eject":
            ejected_at[str(e.get("replica_id", ""))] = ts
            exposure += sync_every
        elif kind == "readmit":
            rid = str(e.get("replica_id", ""))
            if rid in ejected_at:
                flap_pairs += 1
                del ejected_at[rid]
        elif kind == "telemetry":
            telemetry_steps += 1
            # one sync round per sync_every steps, at the codec's cost
            wire_units += wire_factor / max(sync_every, 1.0)
    final = engine.evaluate(next_eval) if next_eval is not None else engine.frame()

    components = {
        "discarded_steps": float(discarded),
        "flapping": float(flap_pairs + engine.flips),
        "projected_wire_units": round(wire_units, 4),
        "recovery_exposure": float(exposure),
    }
    return {
        "policy": spec.name,
        "score": round(sum(_WEIGHTS[k] * v for k, v in components.items()), 4),
        "components": components,
        "final_frame": final,
        "telemetry_steps": telemetry_steps,
        "signals": engine.signals().to_dict(),
    }


def rank_policies(
    events: List[Dict[str, Any]],
    specs: List[PolicySpec],
    window_s: float = 300.0,
    interval_s: float = 5.0,
) -> List[Dict[str, Any]]:
    """Every candidate scored on the same history, best (lowest) first,
    ties by name."""
    scored = [score_policy(events, s, window_s=window_s, interval_s=interval_s) for s in specs]
    scored.sort(key=lambda r: (r["score"], r["policy"]))
    return scored


# -------------------------------------------------------------------- CLI
def _usage() -> int:
    sys.stderr.write(
        "usage: python -m torchft_tpu_torch.policy replay --history FILE"
        " --policy SPEC.json|builtin [SPEC.json ...]\n"
        "       [--window SECONDS] [--interval SECONDS] [--json]\n"
    )
    return 2


def main(argv: List[str]) -> int:
    if not argv or argv[0] != "replay":
        return _usage()
    args = argv[1:]
    history: Optional[str] = None
    policies: List[str] = []
    window_s = 300.0
    interval_s = 5.0
    as_json = False
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--history" and i + 1 < len(args):
            history = args[i + 1]
            i += 2
        elif a == "--policy":
            i += 1
            while i < len(args) and not args[i].startswith("--"):
                policies.append(args[i])
                i += 1
        elif a == "--window" and i + 1 < len(args):
            window_s = float(args[i + 1])
            i += 2
        elif a == "--interval" and i + 1 < len(args):
            interval_s = float(args[i + 1])
            i += 2
        elif a == "--json":
            as_json = True
            i += 1
        else:
            return _usage()
    if history is None or not policies:
        return _usage()

    from torchft_tpu_torch.tracing import load_history

    events = load_history(history)
    specs = [PolicySpec.load(p) for p in policies]
    ranking = rank_policies(events, specs, window_s=window_s, interval_s=interval_s)
    if as_json:
        print(json.dumps({"ranking": ranking}, indent=2, sort_keys=True))
        return 0
    print(f"replayed {len(events)} events against {len(specs)} candidate"
          f" polic{'y' if len(specs) == 1 else 'ies'}"
          f" (window={window_s:g}s interval={interval_s:g}s)")
    for rank, r in enumerate(ranking, 1):
        c = r["components"]
        print(f"  #{rank} {r['policy']}: score={r['score']:g}"
              f" discarded={c['discarded_steps']:g}"
              f" flap={c['flapping']:g}"
              f" wire={c['projected_wire_units']:g}"
              f" exposure={c['recovery_exposure']:g}")
    print(f"winner: {ranking[0]['policy']} — observe it live (TORCHFT_POLICY=observe) before "
          "enforcing")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
