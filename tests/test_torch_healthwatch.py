"""Healthwatch on the port against the reference: straggler scores, the
ledger's escalation policy and its DEGRADED leg on the same inputs through
both packages' functions (scores, events and final states equal), the
native ledger through the port's bindings, and the straggler scenarios on
the port's Manager and trainer.

Layers, as ``tests/test_healthwatch.py`` holds the reference's:
- scoring on synthetic windows (median and MAD, warm-up grace, fleets of
  one and two);
- ``HealthConfig`` from the environment;
- the ``HealthLedger`` state machine on a synthetic clock (observe against
  eject, the min_replicas floor, probation, DEGRADED);
- the native ledger (``coordination.health_scores`` / ``health_replay``)
  against the Python one;
- three port Managers (threads, ``ProcessGroupHost``) against one
  lighthouse, replica 2 REPORTING 10x its step time: under ``eject`` it
  leaves the quorum while its peers commit and is readmitted after
  probation; under ``observe`` membership never changes;
- the trainer's ``slow`` fault (a real host sleep) under ``--health
  eject``: ejected, readmitted, healed, replicas bitwise equal, the
  recorded telemetry replayed through both ledgers to the same
  transitions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import pytest
import torch

from torchft_tpu import healthwatch as ref_hw
from torchft_tpu_torch import healthwatch as hw
from torchft_tpu_torch.healthwatch import HealthConfig, HealthLedger, HealthState

# the policy of the synthetic tests (the reference's): small window and
# thresholds, so scenarios stay a handful of samples long
CFG_FIELDS = dict(mode="eject", window=8, min_samples=3, warn_z=2.0, eject_z=4.0, eject_steps=2,
                  probation_ms=1000, probe_ok=2)
CFG = HealthConfig(**CFG_FIELDS)
REF_CFG = ref_hw.HealthConfig(**CFG_FIELDS)
PKGS = {"port": (hw, CFG), "reference": (ref_hw, REF_CFG)}


def _snapshot(ledger) -> Dict[str, Dict[str, Any]]:
    """Every replica's ledger record, the state as its code."""
    out = {}
    for rid in sorted(ledger._replicas):
        rec = dataclasses.asdict(ledger.replica(rid))
        rec["state"] = int(rec["state"])
        out[rid] = rec
    return out


def _both(run):
    """``run(module, config)`` on each package; asserts the results are
    equal and returns the port's."""
    port = run(*PKGS["port"])
    ref = run(*PKGS["reference"])
    assert port == ref
    return port


# ---------------------------------------------------------------- scoring
class TestScoring:
    def test_median_and_mad(self):
        for values in ([], [3.0], [1.0, 3.0], [5.0, 1.0, 3.0], [1.0, 1.0, 10.0],
                       [0.2, 0.21, 0.19, 0.2, 7.5]):
            assert hw.median(values) == ref_hw.median(values)
            assert hw.mad(values) == ref_hw.mad(values)
        assert hw.median([]) == 0.0
        assert hw.median([1.0, 3.0]) == 2.0
        assert hw.median([5.0, 1.0, 3.0]) == 3.0
        assert hw.mad([1.0, 1.0, 10.0]) == 0.0

    def test_straggler_scores_above_thresholds(self):
        windows = {"a": [0.1] * 5, "b": [0.11] * 5, "c": [0.09] * 5, "slow": [1.0] * 5}
        scores = _both(lambda m, cfg: m.straggler_scores(windows, cfg))
        assert scores["slow"] > CFG.eject_z
        for rid in ("a", "b", "c"):
            assert scores[rid] <= CFG.warn_z

    def test_fast_replica_scores_zero(self):
        windows = {"a": [0.1] * 5, "b": [0.1] * 5, "fast": [0.01] * 5}
        assert _both(lambda m, cfg: m.straggler_scores(windows, cfg))["fast"] == 0.0

    def test_warmup_grace_unscored_and_excluded_from_peer_stats(self):
        windows = {"a": [0.1] * 5, "b": [0.1] * 5, "warming": [50.0]}
        scores = _both(lambda m, cfg: m.straggler_scores(windows, cfg))
        assert scores == {"a": 0.0, "b": 0.0, "warming": 0.0}

    def test_single_replica_never_scores(self):
        assert _both(lambda m, cfg: m.straggler_scores({"solo": [9.9] * 20}, cfg)) == {
            "solo": 0.0}

    def test_two_replica_quorum_cannot_reach_thresholds(self):
        scores = _both(lambda m, cfg: m.straggler_scores({"a": [0.1] * 5, "slow": [10.0] * 5}, cfg))
        assert 0.0 < scores["slow"] < CFG.warn_z
        assert scores["a"] == 0.0


# ----------------------------------------------------------------- config
class TestHealthConfig:
    def test_from_env_defaults(self, monkeypatch):
        for k in list(__import__("os").environ):
            if k.startswith("TORCHFT_HEALTH_"):
                monkeypatch.delenv(k, raising=False)
        cfg = HealthConfig.from_env()
        assert cfg == HealthConfig()
        assert cfg.mode == "observe"
        assert cfg.to_json() == ref_hw.HealthConfig.from_env().to_json()

    def test_from_env_overrides(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_HEALTH_MODE", "EJECT")
        monkeypatch.setenv("TORCHFT_HEALTH_WINDOW", "16")
        monkeypatch.setenv("TORCHFT_HEALTH_WARN_Z", "2.5")
        monkeypatch.setenv("TORCHFT_HEALTH_EJECT_Z", "5.5")
        monkeypatch.setenv("TORCHFT_HEALTH_PROBATION_MS", "1500")
        cfg = HealthConfig.from_env()
        assert (cfg.mode, cfg.window, cfg.warn_z, cfg.eject_z, cfg.probation_ms) == (
            "eject", 16, 2.5, 5.5, 1500)
        assert cfg.to_json() == ref_hw.HealthConfig.from_env().to_json()

    def test_from_env_junk_names_the_variable(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_HEALTH_WINDOW", "lots")
        with pytest.raises(ValueError, match="TORCHFT_HEALTH_WINDOW"):
            HealthConfig.from_env()

    @pytest.mark.parametrize("fields,match", [
        ({"mode": "aggressive"}, "MODE"),
        ({"warn_z": 3.0, "eject_z": 3.0}, "eject_z"),
        ({"window": 0}, "window"),
        ({"min_samples": 0}, "min_samples"),
        ({"eject_steps": 0}, "eject_steps"),
        ({"probation_ms": -1}, "probation_ms"),
        ({"rel_floor": 0.0}, "rel_floor"),
    ])
    def test_validate_rejects_what_the_reference_rejects(self, fields, match):
        with pytest.raises(ValueError, match=match):
            HealthConfig(**fields).validate()
        with pytest.raises(ValueError, match=match):
            ref_hw.HealthConfig(**fields).validate()

    def test_to_json_is_the_references(self):
        assert CFG.to_json() == REF_CFG.to_json()

    def test_unregistered_knob_raises(self):
        from torchft_tpu_torch import knobs

        with pytest.raises(KeyError, match="TORCHFT_HEALTH_MOOD"):
            knobs.env_raw("TORCHFT_HEALTH_MOOD")
        assert knobs.env_raw("TORCHFT_HEALTH_MODE", "x") in ("x", *hw._MODES)


# ---------------------------------------------------------- ledger policy
def _feed_steps(ledger, profiles, steps, t0_ms=0.0, dt_ms=100.0) -> List[Dict[str, Any]]:
    """Beat every replica once a step with its profiled step_s."""
    events: List[Dict[str, Any]] = []
    for step in steps:
        now = t0_ms + step * dt_ms
        for rid, step_s in profiles.items():
            events += ledger.on_heartbeat(rid, {"step": step, "step_s": step_s, "wire_s": 0.0},
                                          now)
    return events


def _ledger_run(script, config=None, **ledger_kw):
    """``script(ledger, module)`` on each package's ledger (``config``: the
    package name -> its config, else ``CFG``'s); asserts equal events and
    equal ledgers, returns the port's (events, ledger)."""
    out = {}
    for name, (m, cfg) in PKGS.items():
        ledger = m.HealthLedger((config or {}).get(name, cfg), **ledger_kw)
        events = script(ledger, m)
        out[name] = (events, _snapshot(ledger), sorted(ledger.exclusions), ledger)
    port, ref = out["port"], out["reference"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    return port[0], port[3]


class TestLedgerPolicy:
    def test_warmup_grace_no_events(self):
        events, ledger = _ledger_run(lambda l, m: _feed_steps(
            l, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, CFG.min_samples)))
        assert events == []
        assert ledger.exclusions == set()

    def test_observe_mode_warns_but_never_ejects(self):
        configs = {"port": dataclasses.replace(CFG, mode="observe"),
                   "reference": dataclasses.replace(REF_CFG, mode="observe")}
        events, ledger = _ledger_run(
            lambda l, m: _feed_steps(l, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, 12)),
            config=configs)
        kinds = [e["kind"] for e in events]
        assert "straggler_warn" in kinds and "eject" not in kinds
        assert ledger.exclusions == set()
        would = [e for e in events if e.get("would_eject")]
        assert would and would[0]["reason"] == "mode=observe"
        assert ledger.state_of("slow") is HealthState.WARN

    def test_eject_mode_escalates_within_eject_steps(self):
        events, ledger = _ledger_run(
            lambda l, m: _feed_steps(l, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, 10)))
        ejects = [e for e in events if e["kind"] == "eject"]
        assert len(ejects) == 1 and ejects[0]["replica_id"] == "slow"
        assert ledger.exclusions == {"slow"}
        assert ledger.state_of("slow") is HealthState.EJECTED
        assert ledger.state_of("a") is HealthState.OK
        assert ledger.replica("slow").window == []

    def test_min_replicas_floor_blocks_ejection(self):
        events, ledger = _ledger_run(
            lambda l, m: _feed_steps(l, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, 10)),
            min_replicas=3)
        assert not [e for e in events if e["kind"] == "eject"]
        would = [e for e in events if e.get("would_eject")]
        assert would and would[0]["reason"] == "min_replicas floor"
        assert ledger.exclusions == set()

    @pytest.mark.parametrize("profiles", [{"solo": 5.0}, {"a": 0.1, "slow": 5.0}])
    def test_one_and_two_replica_fleets_never_eject(self, profiles):
        events, ledger = _ledger_run(lambda l, m: _feed_steps(l, profiles, range(1, 30)))
        assert events == []
        assert ledger.exclusions == set()

    @staticmethod
    def _ejected(ledger):
        _feed_steps(ledger, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, 6))
        assert int(ledger.state_of("slow")) == HealthState.EJECTED
        return ledger.replica("slow").ejected_at_ms

    def test_probation_and_clean_probes_readmit(self):
        def script(ledger, m):
            ejected_at = self._ejected(ledger)
            events = []
            ledger.on_heartbeat("slow", None, ejected_at + 400)
            early = ledger.tick(ejected_at + 500)
            assert early == [] and ledger.exclusions == {"slow"}
            ledger.on_heartbeat("slow", None, ejected_at + CFG.probation_ms)
            events += ledger.tick(ejected_at + CFG.probation_ms)
            assert int(ledger.state_of("slow")) == HealthState.PROBATION
            t0 = ejected_at + CFG.probation_ms
            last = ledger.replica("slow").last_step
            for i in range(1, CFG.min_samples + CFG.probe_ok):
                for rid in ("a", "b", "slow"):
                    events += ledger.on_heartbeat(
                        rid, {"step": last + i, "step_s": 0.1, "wire_s": 0.0}, t0 + i * 100)
                if i < CFG.min_samples + CFG.probe_ok - 1:
                    assert int(ledger.state_of("slow")) == HealthState.PROBATION, i
            return events

        events, ledger = _ledger_run(script)
        assert [e["kind"] for e in events] == ["readmit"]
        assert ledger.exclusions == set()
        assert ledger.state_of("slow") is HealthState.OK
        rh = ledger.replica("slow")
        assert (rh.ejections, rh.readmissions) == (1, 1)

    def test_probation_strike_re_ejects_immediately(self):
        def script(ledger, m):
            ejected_at = self._ejected(ledger)
            ledger.on_heartbeat("slow", None, ejected_at + CFG.probation_ms)
            events = ledger.tick(ejected_at + CFG.probation_ms)
            t0 = ejected_at + CFG.probation_ms
            last = ledger.replica("slow").last_step
            for i in range(1, CFG.min_samples + 1):
                for rid, step_s in (("a", 0.1), ("b", 0.1), ("slow", 1.0)):
                    events += ledger.on_heartbeat(
                        rid, {"step": last + i, "step_s": step_s, "wire_s": 0.0}, t0 + i * 100)
            return events

        events, ledger = _ledger_run(script)
        assert [e["kind"] for e in events] == ["readmit", "eject"]
        assert ledger.state_of("slow") is HealthState.EJECTED
        assert ledger.replica("slow").ejections == 2

    def test_beat_gap_restarts_probation_clock(self):
        def script(ledger, m):
            ejected_at = self._ejected(ledger)
            gap_beat = ejected_at + ledger.heartbeat_timeout_ms + 1000
            ledger.on_heartbeat("slow", None, gap_beat)
            assert ledger.tick(gap_beat) == []
            assert ledger.exclusions == {"slow"}
            ledger.on_heartbeat("slow", None, gap_beat + CFG.probation_ms)
            return ledger.tick(gap_beat + CFG.probation_ms)

        events, _ = _ledger_run(script)
        assert [e["kind"] for e in events] == ["readmit"]

    def test_silent_replica_is_pruned(self):
        def script(ledger, m):
            _feed_steps(ledger, {"a": 0.1, "b": 0.1}, range(1, 4))
            ledger.on_heartbeat("a", None, 5000.0)
            return ledger.tick(5000.0, prune_after_ms=1000)

        events, ledger = _ledger_run(script)
        assert events == []
        assert ledger.replica("b") is None and ledger.replica("a") is not None

    def test_off_mode_records_nothing(self):
        configs = {"port": dataclasses.replace(CFG, mode="off"),
                   "reference": dataclasses.replace(REF_CFG, mode="off")}
        events, ledger = _ledger_run(
            lambda l, m: _feed_steps(l, {"a": 0.1, "b": 0.1, "slow": 1.0}, range(1, 10))
            + l.tick(2000.0), config=configs)
        assert events == [] and ledger.replica("slow") is None


# --------------------------------------------------------------- degraded
def _beat(ledger, rid, step, step_s, now, gws=None, full=None):
    telemetry = {"step": step, "step_s": step_s, "wire_s": 0.0}
    if gws is not None:
        telemetry["group_world_size"] = gws
        telemetry["full_group_world_size"] = full
    return ledger.on_heartbeat(rid, telemetry, now)


class TestDegraded:
    def test_reduced_capacity_beat_enters_degraded(self):
        events, ledger = _ledger_run(lambda l, m: _beat(l, "c", 1, 0.4, 100.0, gws=3, full=4),
                                     heartbeat_timeout_ms=5000, min_replicas=1)
        assert [e["kind"] for e in events] == ["degrade"]
        assert (events[0]["group_world_size"], events[0]["full_group_world_size"]) == (3, 4)
        assert ledger.replica("c").state is HealthState.DEGRADED

    def test_capacity_scaled_sample_scores_like_peers(self):
        def script(l, m):
            for step in range(1, 8):
                now = step * 100.0
                _beat(l, "a", step, 0.3, now)
                _beat(l, "b", step, 0.3, now)
                _beat(l, "c", step, 0.4, now, gws=3, full=4)
            return []

        _, ledger = _ledger_run(script, heartbeat_timeout_ms=5000, min_replicas=1)
        assert all(s == pytest.approx(0.3) for s in ledger.replica("c").window)

    def test_degraded_never_strikes_even_when_genuinely_slow(self):
        def script(l, m):
            events = []
            for step in range(1, 12):
                now = step * 100.0
                events += _beat(l, "a", step, 0.1, now)
                events += _beat(l, "b", step, 0.1, now)
                events += _beat(l, "c", step, 1.0, now, gws=3, full=4)
                events += l.tick(now + 50.0)
            return events

        events, ledger = _ledger_run(script, heartbeat_timeout_ms=5000, min_replicas=1)
        assert "eject" not in [e["kind"] for e in events]
        rh = ledger.replica("c")
        assert rh.state is HealthState.DEGRADED and rh.strikes == 0
        assert ledger.exclusions == set()

    @pytest.mark.parametrize("state", [*HealthState, *(s.name.lower() for s in HealthState),
                                       "bogus", 7, None])
    @pytest.mark.parametrize("drain_on", ["warn", "eject"])
    def test_serving_and_spare_eligibility_are_the_references(self, state, drain_on):
        assert hw.serving_eligible(state, drain_on) == ref_hw.serving_eligible(state, drain_on)
        assert hw.spare_eligible(state) == ref_hw.spare_eligible(state)

    def test_degraded_drains_from_serving_under_both_policies(self):
        for drain_on in ("warn", "eject"):
            assert not hw.serving_eligible(HealthState.DEGRADED, drain_on)
            assert not hw.serving_eligible("degraded", drain_on)
        assert hw.serving_eligible(HealthState.OK, "warn")
        assert hw.serving_eligible(HealthState.WARN, "eject")
        assert not hw.serving_eligible(HealthState.WARN, "warn")
        with pytest.raises(ValueError, match="drain_on"):
            hw.serving_eligible("ok", "never")

    def test_full_capacity_beat_restores_to_ok(self):
        def script(l, m):
            _beat(l, "c", 1, 0.4, 100.0, gws=3, full=4)
            assert int(l.replica("c").state) == HealthState.DEGRADED
            return _beat(l, "c", 2, 0.3, 200.0, gws=4, full=4)

        events, ledger = _ledger_run(script, heartbeat_timeout_ms=5000, min_replicas=1)
        assert [e["kind"] for e in events] == ["restore"]
        assert events[0]["group_world_size"] == 4
        assert ledger.replica("c").state is HealthState.OK

    def test_telemetry_without_capacity_keys_changes_nothing(self):
        def run(keyed):
            def script(l, m):
                events = []
                for step in range(1, 10):
                    now = step * 100.0
                    for rid, step_s in (("a", 0.1), ("b", 0.1), ("slow", 1.0)):
                        t = {"step": step, "step_s": step_s, "wire_s": 0.0}
                        if keyed:
                            t.update(group_world_size=4, full_group_world_size=4)
                        events += l.on_heartbeat(rid, t, now)
                    events += l.tick(now + 50.0)
                return events

            return _ledger_run(script, heartbeat_timeout_ms=5000, min_replicas=1)

        (plain_events, plain), (keyed_events, keyed) = run(False), run(True)
        assert [e["kind"] for e in plain_events] == [e["kind"] for e in keyed_events]
        assert plain.replica("slow").window == keyed.replica("slow").window
        assert plain.replica("slow").state == keyed.replica("slow").state

    def test_degraded_warn_state_also_enters_degraded(self):
        configs = {"port": dataclasses.replace(CFG, mode="observe"),
                   "reference": dataclasses.replace(REF_CFG, mode="observe")}

        def script(l, m):
            for step in range(1, 6):
                now = step * 100.0
                _beat(l, "a", step, 0.1, now)
                _beat(l, "b", step, 0.1, now)
                _beat(l, "c", step, 0.5, now)
                l.tick(now + 50.0)
            assert int(l.replica("c").state) == HealthState.WARN
            return _beat(l, "c", 6, 0.4, 600.0, gws=3, full=4)

        _, ledger = _ledger_run(script, config=configs, heartbeat_timeout_ms=5000, min_replicas=1)
        assert ledger.replica("c").state is HealthState.DEGRADED


# ---------------------------------------------------------- native parity
def _replay_both(script, opts):
    """One beat/tick script through the native ledger (the port's binding)
    and the port's Python ledger: their (t_ms, kind, replica) sequences."""
    from torchft_tpu_torch.coordination import health_replay

    native = health_replay(script, opts)
    ledger = HealthLedger(CFG, heartbeat_timeout_ms=opts["heartbeat_timeout_ms"],
                          min_replicas=opts["min_replicas"])
    py_events = []
    for entry in script:
        if entry.get("tick"):
            evs = ledger.tick(entry["t_ms"])
        else:
            evs = ledger.on_heartbeat(entry["replica_id"], entry.get("telemetry"), entry["t_ms"])
        py_events += [dict(e, t_ms=entry["t_ms"]) for e in evs]
    native_seq = [(e["t_ms"], e["kind"], e["replica_id"]) for e in native["events"]]
    py_seq = [(e["t_ms"], e["kind"], e["replica_id"]) for e in py_events]
    assert native_seq == py_seq
    assert native["excluded"] == sorted(ledger.exclusions)
    return native, ledger, py_seq


class TestNativeParity:
    @pytest.mark.parametrize("windows", [
        {"a": [0.1] * 5, "b": [0.11] * 5, "c": [0.09] * 5, "slow": [1.0] * 5},
        {"a": [0.1] * 5, "slow": [10.0] * 5},
        {"solo": [9.9] * 8},
        {"a": [0.1] * 5, "b": [0.1] * 5, "warming": [50.0]},
        {"a": [0.2, 0.21, 0.19, 0.2], "b": [0.2, 0.2, 0.22, 0.18], "c": [0.6, 0.62, 0.58, 0.61]},
    ])
    def test_scores_match_native(self, windows):
        from torchft_tpu import coordination as ref_coord
        from torchft_tpu_torch.coordination import health_scores

        py = hw.straggler_scores(windows, CFG)
        native = health_scores(windows, CFG.to_json())
        assert set(py) == set(native)
        for rid in py:
            assert native[rid] == pytest.approx(py[rid], abs=1e-9), rid
        # the reference's binding runs the same native code
        assert native == ref_coord.health_scores(windows, REF_CFG.to_json())

    def test_ledger_replay_matches_native(self):
        opts = dict(CFG.to_json(), heartbeat_timeout_ms=5000, min_replicas=1)
        script: List[Dict[str, Any]] = []
        profiles = {"a": 0.1, "b": 0.1, "c": 1.0}
        for step in range(1, 7):
            t = step * 100
            for rid, step_s in profiles.items():
                script.append({"t_ms": t, "replica_id": rid,
                               "telemetry": {"step": step, "step_s": step_s, "wire_s": 0.0}})
            script.append({"t_ms": t + 50, "tick": True})
        for t in range(700, 1600, 100):
            script.append({"t_ms": t, "replica_id": "c"})
            script.append({"t_ms": t + 50, "tick": True})
        for i, step in enumerate(range(7, 13)):
            t = 1600 + i * 100
            for rid in profiles:
                script.append({"t_ms": t, "replica_id": rid,
                               "telemetry": {"step": step, "step_s": 0.1, "wire_s": 0.0}})
        native, ledger, seq = _replay_both(script, opts)
        assert [k for _, k, _ in seq] == ["straggler_warn", "eject", "readmit"]
        assert native["excluded"] == []
        rep = native["ledger"]["replicas"]["c"]
        rh = ledger.replica("c")
        assert rep["state"] == HealthState(rh.state).name.lower() == "ok"
        assert rep["ejections"] == rh.ejections == 1
        assert rep["readmissions"] == rh.readmissions == 1

    def test_degrade_restore_replay_matches_native(self):
        opts = dict(CFG.to_json(), heartbeat_timeout_ms=5000, min_replicas=1)

        def entry(t, rid, step, step_s, gws=None, full=None):
            telemetry = {"step": step, "step_s": step_s, "wire_s": 0.0}
            if gws is not None:
                telemetry.update(group_world_size=gws, full_group_world_size=full)
            return {"t_ms": t, "replica_id": rid, "telemetry": telemetry}

        script: List[Dict[str, Any]] = []
        for step in range(1, 12):
            t = step * 100
            script += [entry(t, "a", step, 0.1), entry(t, "b", step, 0.1)]
            if step < 4:
                script.append(entry(t, "c", step, 0.1))
            elif step < 10:
                script.append(entry(t, "c", step, 0.4 / 3, gws=3, full=4))
            else:
                script.append(entry(t, "c", step, 0.1, gws=4, full=4))
            script.append({"t_ms": t + 50, "tick": True})
        native, ledger, seq = _replay_both(script, opts)
        assert [k for _, k, _ in seq] == ["degrade", "restore"]
        rep = native["ledger"]["replicas"]["c"]
        assert rep["state"] == HealthState(ledger.replica("c").state).name.lower() == "ok"
        assert rep["ejections"] == 0 and ledger.replica("c").strikes == 0

    def test_degraded_final_state_name_matches_native(self):
        from torchft_tpu_torch.coordination import health_replay

        opts = dict(CFG.to_json(), heartbeat_timeout_ms=5000, min_replicas=1)
        telemetry = {"step": 1, "step_s": 0.4, "wire_s": 0.0, "group_world_size": 3,
                     "full_group_world_size": 4}
        native = health_replay([{"t_ms": 100, "replica_id": "c", "telemetry": telemetry}], opts)
        ledger = HealthLedger(CFG, heartbeat_timeout_ms=5000, min_replicas=1)
        ledger.on_heartbeat("c", telemetry, 100.0)
        rep = native["ledger"]["replicas"]["c"]
        rh = ledger.replica("c")
        assert rep["state"] == HealthState(rh.state).name.lower() == "degraded"
        assert rep["group_world_size"] == rh.group_world_size == 3
        assert rep["full_group_world_size"] == rh.full_group_world_size == 4

    def test_lighthouse_takes_health_options_and_retunes(self):
        from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=CFG.to_json())
        try:
            assert LighthouseClient(f"127.0.0.1:{lh.port}").health()["mode"] == "eject"
            opts = lh.retune_health({"eject_z": 9.0})
            assert opts["eject_z"] == 9.0 and opts["warn_z"] == CFG.warn_z
        finally:
            lh.shutdown()


# ------------------------------------------------------ live integration
HEALTH_OPTS = dict(CFG_FIELDS, probation_ms=1500)
STEP_SLEEP_S = 0.03  # dwarfs scheduler jitter so compute windows are tight


class _Dilation:
    """A telemetry transform per replica that reports ``factor`` times the
    true ``step_s`` while armed (the reference's
    ``EventInjector.slow_replica``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slow: Dict[int, float] = {}

    def arm(self, replica: int, factor: float) -> None:
        with self._lock:
            self._slow[replica] = factor

    def clear(self, replica: int) -> None:
        with self._lock:
            self._slow.pop(replica, None)

    def transform(self, replica: int):
        def apply(telemetry: Dict[str, Any]) -> Dict[str, Any]:
            with self._lock:
                factor = self._slow.get(replica)
            if factor is not None:
                telemetry = dict(telemetry, step_s=telemetry["step_s"] * factor)
            return telemetry

        return apply


def _run_fleet(health, target, straggler, on_tick=None, n_replicas=3, timeout_s=180.0):
    """Three one-rank replica groups of the port against one lighthouse;
    ``straggler`` reports 10x its step time. Finished replicas drain with
    zero gradients until the whole fleet is done, so a readmitted straggler
    heals from a live peer. ``on_tick(client, dilation, step_log)`` runs
    every ~50 ms. Returns the final /health payload, the Managers and each
    replica's committed steps."""
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    dilation = _Dilation()
    dilation.arm(straggler, 10.0)
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=1000,
                          quorum_tick_ms=20, heartbeat_timeout_ms=800, health=health)
    client = LighthouseClient(f"127.0.0.1:{lh.port}", connect_timeout=5.0)
    finals: Dict[int, torch.Tensor] = {}
    step_log: Dict[int, List[int]] = {r: [] for r in range(n_replicas)}
    managers: Dict[int, Any] = {}
    fleet_done = threading.Event()
    failure: List[BaseException] = []

    def replica(rid: int) -> None:
        gen = torch.Generator().manual_seed(500 + rid)
        grad_base = torch.randn(8, generator=gen)
        params = {"w": torch.zeros(8)}

        def load(sd):
            params["w"] = sd["w"].clone()

        manager = Manager(
            pg=ProcessGroupHost(timeout=8.0), load_state_dict=load,
            state_dict=lambda: {"w": params["w"].clone()}, min_replica_size=1,
            use_async_quorum=True, replica_id=f"hw_{rid}",
            lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=8.0, quorum_timeout=4.0,
            # telemetry rides the beats: beat faster than the ~40 ms steps
            heartbeat_interval=0.02,
        )
        manager.set_telemetry_transform(dilation.transform(rid))
        managers[rid] = manager
        zgrads = {"w": torch.zeros(8)}
        try:
            while manager.current_step() < target:
                manager.start_quorum()
                if manager.current_step() >= target:
                    # healed straight to the end: finish the joined quorum
                    manager.allreduce(zgrads).get_future().wait(30)
                    if manager.should_commit():
                        break
                    continue
                step = manager.current_step()
                time.sleep(STEP_SLEEP_S)
                avg = manager.allreduce({"w": grad_base * (1.0 + 0.01 * step)}).get_future().wait(30)
                if manager.should_commit():
                    params["w"] = params["w"] - 0.05 * avg["w"]
                    step_log[rid].append(manager.current_step())
            finals[rid] = params["w"].clone()
            if len(finals) == n_replicas:
                # one settling drain cycle: the post-readmission summary
                # reaches timings() before the teardown
                time.sleep(0.1)
                manager.start_quorum()
                manager.allreduce(zgrads).get_future().wait(30)
                manager.should_commit()
                fleet_done.set()
            while not fleet_done.is_set():
                manager.start_quorum()
                manager.allreduce(zgrads).get_future().wait(30)
                manager.should_commit()
        except BaseException as e:  # noqa: BLE001
            failure.append(e)
            raise
        finally:
            manager.shutdown(wait=False)

    final_health: Dict[str, Any] = {}
    ex = ThreadPoolExecutor(max_workers=n_replicas)
    try:
        futs = [ex.submit(replica, r) for r in range(n_replicas)]
        deadline = time.monotonic() + timeout_s
        while not fleet_done.is_set() and time.monotonic() < deadline and not failure:
            if on_tick is not None:
                on_tick(client, dilation, step_log)
            time.sleep(0.05)
        final_health = client.health()
        for f in futs:
            f.result(timeout=max(5.0, deadline - time.monotonic()))
    finally:
        fleet_done.set()
        ex.shutdown(wait=False, cancel_futures=True)
        lh.shutdown()
    assert not failure, failure
    assert set(finals) == set(range(n_replicas)), finals.keys()
    return final_health, managers, step_log


def _replica_entry(payload: Dict[str, Any], rid: int) -> Dict[str, Any]:
    matches = [v for k, v in payload.get("replicas", {}).items() if k.startswith(f"hw_{rid}:")]
    assert matches, (rid, payload)
    return matches[0]


class TestFleetIntegration:
    def test_eject_mode_excludes_then_readmits(self):
        straggler = 2
        observed: Dict[str, Any] = {}

        def on_tick(client, dilation, step_log):
            try:
                payload = client.health(timeout=2.0)
            except Exception:  # noqa: BLE001 - the poll races the teardown
                return
            excluded = payload.get("excluded", [])
            if excluded and "ejected_at" not in observed:
                observed["ejected_at"] = {r: len(step_log[r]) for r in step_log}
                observed["excluded"] = list(excluded)
                # the straggler recovers: its reports are honest from here
                dilation.clear(straggler)

        final_health, managers, step_log = _run_fleet(HEALTH_OPTS, target=25,
                                                      straggler=straggler, on_tick=on_tick)
        assert "ejected_at" in observed, final_health
        assert all(ex.startswith(f"hw_{straggler}:") for ex in observed["excluded"]), observed
        assert observed["ejected_at"][straggler] <= (
            HEALTH_OPTS["min_samples"] + HEALTH_OPTS["eject_steps"] + 4), observed
        for peer in (0, 1):
            assert managers[peer].current_step() >= 25
            assert len(step_log[peer]) >= observed["ejected_at"][peer] + 3, (peer, observed)
        kinds = [e["kind"] for e in final_health.get("recent_events", [])]
        assert "readmit" in kinds, final_health
        assert final_health.get("excluded", []) == [], final_health
        assert managers[straggler].current_step() >= 25
        t = managers[straggler].timings()
        assert t["ejections"] >= 1.0 and t["readmissions"] >= 1.0, t
        for peer in (0, 1):
            assert managers[peer].timings()["ejections"] == 0.0

    def test_observe_mode_warns_without_membership_change(self):
        straggler = 2
        polls: List[List[str]] = []

        def on_tick(client, dilation, step_log):
            try:
                polls.append(client.health(timeout=2.0).get("excluded", []))
            except Exception:  # noqa: BLE001
                pass

        final_health, managers, step_log = _run_fleet(
            dict(HEALTH_OPTS, mode="observe"), target=12, straggler=straggler, on_tick=on_tick)
        assert polls and all(ex == [] for ex in polls), polls
        assert final_health.get("excluded", []) == []
        entry = _replica_entry(final_health, straggler)
        assert entry["state"] == "warn" and entry["ejections"] == 0, final_health
        warns = [e for e in final_health.get("recent_events", [])
                 if e["kind"] == "straggler_warn" and e["replica_id"].startswith(f"hw_{straggler}:")]
        assert any(e.get("would_eject") and e.get("reason") == "mode=observe" for e in warns), warns
        assert "eject" not in {e["kind"] for e in final_health.get("recent_events", [])}
        for rid, log in step_log.items():
            assert log and log[-1] == 12 and len(log) >= 11, (rid, step_log)
            assert log == list(range(log[0], 13)), (rid, step_log)
        t = managers[straggler].timings()
        assert t["health_state"] == float(HealthState.WARN), t
        assert t["straggler_score"] > HEALTH_OPTS["warn_z"], t


def test_trainer_slow_replica_is_ejected_readmitted_and_heals(tmp_path, monkeypatch):
    """``train.run_replicas`` with a ``slow`` replica (a real host sleep
    before each allreduce, until it sees itself ejected) under ``health
    eject``: replica 2 is ejected while its peers train on, readmitted after
    probation, heals, and the three end bitwise equal; the merged trace
    shows its heal, and its recorded telemetry replays to the same
    transitions through the native and the Python ledger."""
    import json

    from torchft_tpu_torch.train import Fault, TrainConfig, run_replicas
    from torchft_tpu_torch.tracing import load_history

    for name, value in (("MIN_SAMPLES", "3"), ("EJECT_STEPS", "2"), ("PROBATION_MS", "1000"),
                        ("PROBE_OK", "2")):
        monkeypatch.setenv(f"TORCHFT_HEALTH_{name}", value)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fleet: Dict[str, Any] = {}
    try:
        results = run_replicas(
            TrainConfig(config="debug", seq_len=16, steps=8, replicas=3, quantize=True,
                        health="eject", trace_dir=str(tmp_path),
                        faults=(Fault(2, 2, "slow", at="backward", times=-1),)),
            "cpu", fleet=fleet)
    finally:
        torch.set_num_threads(n)
    slow = results[2]
    assert slow["timings"]["ejections"] == 1.0 and slow["timings"]["readmissions"] == 1.0
    assert slow["metrics"]["heals"] >= 1
    assert [r["timings"]["ejections"] for r in results[:2]] == [0.0, 0.0]
    assert [e["slow_ms"] > 0 for e in slow["log"]].count(True) >= 2
    out = [e for e in results[0]["log"] if e["participants"] == 2]
    assert len(out) >= 2, "the peers trained on while replica 2 was out"
    for r in results[1:]:
        assert r["step"] == results[0]["step"] >= 8
        for k, v in results[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    kinds = [e["kind"] for e in fleet["health"]["recent_events"]]
    assert "eject" in kinds and "readmit" in kinds

    with open(fleet["trace"]) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    heals = {e["args"]["replica_id"].split(":")[0] for e in spans if e["name"] == "heal_recv"}
    assert "replica_2" in heals
    for rid in ("replica_0", "replica_1", "replica_2"):
        names = {e["name"] for e in spans if e["args"]["replica_id"].startswith(rid + ":")}
        assert {"quorum_rpc", "pack", "wire", "unpack", "commit_vote"} <= names, (rid, names)

    history = load_history(str(tmp_path / "lighthouse_history.jsonl"))
    opts = dict(HealthConfig.from_env().to_json(), mode="eject", heartbeat_timeout_ms=2000,
                min_replicas=2)
    from torchft_tpu_torch.coordination import health_replay

    script = hw.history_script(history)
    native = health_replay(script, opts)
    ledger = HealthLedger(dataclasses.replace(HealthConfig.from_env(), mode="eject"),
                          heartbeat_timeout_ms=2000, min_replicas=2)
    py = []
    for entry in script:
        evs = (ledger.tick(entry["t_ms"]) if entry.get("tick")
               else ledger.on_heartbeat(entry["replica_id"], entry.get("telemetry"), entry["t_ms"]))
        py += [(entry["t_ms"], e["kind"], e["replica_id"]) for e in evs]
    assert [(e["t_ms"], e["kind"], e["replica_id"]) for e in native["events"]] == py
    assert any(k == "eject" and r.startswith("replica_2:") for _, k, r in py), py


def test_history_script_beats_every_replica_between_telemetry():
    events = [
        {"kind": "quorum", "quorum_id": 1, "ts_ms": 0},
        {"kind": "telemetry", "replica_id": "a", "step": 1, "ts_ms": 1000,
         "telemetry": {"step": 1, "step_s": 0.1, "wire_s": 0.0}},
        {"kind": "telemetry", "replica_id": "b", "step": 1, "ts_ms": 1250,
         "telemetry": {"step": 1, "step_s": 0.1, "wire_s": 0.0}},
    ]
    script = hw.history_script(events)
    assert [x["t_ms"] for x in script] == [1000, 1000, 1100, 1100, 1100, 1200, 1200, 1200,
                                           1250, 1250]
    assert [x.get("replica_id") for x in script if "telemetry" in x] == ["a", "b"]
    assert hw.history_script(events[:1]) == []
