"""The port's policy plane (``torchft_tpu_torch/policy.py`` and its wiring)
against the JAX package's (``torchft_tpu/policy.py``, ``tests/test_policy.py``'s
scenarios).

Every scenario feeds the same inputs to both packages and compares what
comes out: spec validation, clamps and JSON round trips; ``fold_signals``
over the reference's ``_test/event_injector`` scripts (``Signals`` equal
field for field); the engine's frames stepped along the same event times;
the controller's publishes and health retunes on stubs; replay scores,
rankings and the replay CLI's output and exit codes; the wire (a policy
key on beat replies only once a frame is published, unknown frame keys
through the port's aggregator, an ``agg_tick`` with unknown parameters);
the Manager's quorum safe point in off, observe and enforce modes under one
frame script, the redundancy plane's adjusters, LocalSGD's and DiLoCo's
``TORCHFT_SYNC_EVERY`` adjusters, the doctor's ``policy-env`` and an
``TORCHFT_COMPRESS`` retarget that lands one replica at a time.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu import doctor as ref_doctor
from torchft_tpu import knobs as ref_knobs
from torchft_tpu import policy as ref
from torchft_tpu._test.event_injector import churn_burst, mtbf_script
from torchft_tpu_torch import doctor, knobs, policy
from torchft_tpu_torch.coordination import (
    AggregatorServer,
    LighthouseClient,
    LighthouseServer,
    _RawClient,
)
from torchft_tpu_torch.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_RETRY = RetryPolicy(max_attempts=1)
HEALTH_OFF = {"mode": "off"}
PACKAGES = {"jax": ref, "torch": policy}
POLICY_ENV = ("TORCHFT_POLICY", "TORCHFT_POLICY_SPEC", "TORCHFT_POLICY_INTERVAL_S",
              "TORCHFT_POLICY_WINDOW_S", "TORCHFT_POLICY_RING", "TORCHFT_SYNC_EVERY",
              "TORCHFT_COMPRESS")


@pytest.fixture(autouse=True)
def _clean_policy_state(monkeypatch):
    """The override layers are process-wide and several scenarios set
    TORCHFT_POLICY: neither leaks into the next test."""
    for var in POLICY_ENV:
        monkeypatch.delenv(var, raising=False)
    yield
    knobs.clear_overrides()
    ref_knobs.clear_overrides()


def _rule(pkg, **kw):
    base = dict(name="r", signal="churn_per_min", op=">", threshold=6.0, release=2.0,
                actions={"TORCHFT_SYNC_EVERY": "64"})
    base.update(kw)
    return pkg.PolicyRule(**base)


def _quorum_events(ts_and_sets, seq0=0):
    return [{"ts_ms": ts, "seq": seq0 + i, "kind": "quorum", "quorum_id": i,
             "participants": sorted(parts)} for i, (ts, parts) in enumerate(ts_and_sets)]


def _telemetry(n, ts0=0, seq0=0, rid="r0", faults=()):
    """``n`` telemetry snapshots of ``rid``, one a second, its cumulative
    link-fault counters growing as ``faults`` says (rpc_retries,
    collective_reroute, chunk_crc_failures by turns)."""
    keys = ("rpc_retries", "collective_reroute", "chunk_crc_failures")
    counters = dict.fromkeys(keys, 0.0)
    out = []
    for i in range(n):
        if i < len(faults):
            counters[keys[i % 3]] += faults[i]
        out.append({"ts_ms": ts0 + 1000 * i, "seq": seq0 + i, "kind": "telemetry",
                    "replica_id": rid, "telemetry": {"step": i, "step_s": 0.1, **counters}})
    return out


def _mixed_history():
    """Churn, failures, warnings, readmissions, heals and telemetry from
    four replicas over ~3 minutes: every branch of the fold and the
    scorer."""
    events = churn_burst(10, period_s=6.0, replicas=4)
    events += mtbf_script([15.0, 25.0, 40.0], replica="replica_1", start_ms=20_000, seq0=100)
    events += _telemetry(40, ts0=5_000, seq0=200, rid="replica_2", faults=(0, 1, 0, 2, 1))
    events += _telemetry(30, ts0=9_500, seq0=300, rid="replica_3")
    events += [
        {"ts_ms": 31_000, "seq": 400, "kind": "straggler_warn", "replica_id": "replica_3"},
        {"ts_ms": 36_000, "seq": 401, "kind": "readmit", "replica_id": "replica_1"},
        {"ts_ms": 47_000, "seq": 402, "kind": "heal", "replica_id": "replica_0",
         "from_step": 12, "to_step": 19},
        {"ts_ms": 90_000, "seq": 403, "kind": "readmit", "replica_id": "replica_1"},
        {"ts_ms": 150_000, "seq": 404, "kind": "quorum", "quorum_id": 50,
         "participants": ["replica_0", "replica_1"]},
    ]
    return events


# ------------------------------------------------------------------- spec
def test_builtin_spec_is_the_reference_and_round_trips():
    spec = policy.builtin_spec()
    spec.validate()
    assert spec.to_json() == ref.builtin_spec().to_json()
    assert policy.PolicySpec.from_json(spec.to_json()).to_json() == spec.to_json()
    assert policy.PolicySpec.load("builtin").name == "builtin"
    assert policy.POLICY_MODES == ref.POLICY_MODES
    assert policy.SIGNALS == ref.SIGNALS


def test_spec_files_load_alike(tmp_path):
    p = tmp_path / "cand.json"
    p.write_text(json.dumps({
        "name": "cand",
        "rules": [{"name": "a", "signal": "link_quality", "op": "<=", "threshold": 0.8,
                   "release": 0.95, "actions": {"TORCHFT_COMPRESS": "int8"}},
                  {"name": "b", "signal": "mtbf_s", "op": "<", "threshold": 60,
                   "release": 90, "actions": {"TORCHFT_REDUNDANCY_M": 3}}],
        "clamps": {"TORCHFT_REDUNDANCY_M": [1, 2]},
    }))
    assert policy.PolicySpec.load(str(p)).to_json() == ref.PolicySpec.load(str(p)).to_json()


INVALID = {
    "unknown_signal": (lambda pkg: pkg.PolicySpec("s", [_rule(pkg, signal="cpu_temp")]),
                       "unknown signal"),
    "unknown_op": (lambda pkg: pkg.PolicySpec("s", [_rule(pkg, op="==")]), "unknown op"),
    "release_above_a_gt_rule": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg, threshold=6.0, release=8.0)]), "hysteresis"),
    "release_below_a_lt_rule": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg, op="<", threshold=0.5, release=0.1)]),
        "hysteresis"),
    "no_actions": (lambda pkg: pkg.PolicySpec("s", [_rule(pkg, actions={})]), "no actions"),
    "unregistered_action": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg, actions={"TORCHFT_NOT_A_KNOB": "1"})]),
        "unregistered"),
    "duplicate_names": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg, name="a"), _rule(pkg, name="a")]),
        "duplicate"),
    "unregistered_clamp": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg)], clamps={"TORCHFT_NOT_A_KNOB": (0, 1)}),
        "unregistered"),
    "clamp_min_over_max": (
        lambda pkg: pkg.PolicySpec("s", [_rule(pkg)], clamps={"TORCHFT_SYNC_EVERY": (64, 1)}),
        "min"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_specs_fail_alike(case):
    make, match = INVALID[case]
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match=match):
            make(pkg).validate()
        with pytest.raises(ValueError, match=match):
            pkg.PolicySpec.from_json(make(pkg).to_json())


@pytest.mark.parametrize("knob, value", [
    ("TORCHFT_SYNC_EVERY", "64"), ("TORCHFT_SYNC_EVERY", "16"), ("TORCHFT_SYNC_EVERY", "0"),
    ("TORCHFT_SYNC_EVERY", "7.5"), ("TORCHFT_HEALTH_EJECT_Z", "20"),
    ("TORCHFT_HEALTH_EJECT_Z", "1.0"), ("TORCHFT_HEALTH_EJECT_Z", "9"),
    ("TORCHFT_COMPRESS", "int8"), ("TORCHFT_REDUNDANCY_M", "nine"),
])
def test_clamps_match(knob, value):
    clamps = {"TORCHFT_SYNC_EVERY": (1, 32), "TORCHFT_HEALTH_EJECT_Z": (3.0, 12.0)}
    got = {name: pkg.PolicySpec("s", [_rule(pkg)], clamps=clamps).clamp(knob, value)
           for name, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------- signals
def _fold_both(events, window_s, now_ms=None):
    out = {name: pkg.fold_signals(events, window_s=window_s, now_ms=now_ms)
           for name, pkg in PACKAGES.items()}
    assert dataclasses.asdict(out["torch"]) == dataclasses.asdict(out["jax"])
    assert out["torch"].to_dict() == out["jax"].to_dict()
    return out["torch"]


def test_empty_events_fold_to_calm_defaults():
    sig = _fold_both([], window_s=60.0, now_ms=60_000)
    assert (sig.failures, sig.churn_per_min, sig.link_quality) == (0, 0.0, 1.0)
    assert sig.mtbf_s == pytest.approx(60.0)


@pytest.mark.parametrize("n, period_s, replicas, window_s", [
    (6, 10.0, 4, 120.0), (8, 5.0, 4, 300.0), (3, 2.0, 2, 10.0), (12, 7.0, 3, 30.0)])
def test_churn_bursts_fold_alike(n, period_s, replicas, window_s):
    sig = _fold_both(churn_burst(n, period_s=period_s, replicas=replicas), window_s)
    assert sig.replicas == replicas


def test_mtbf_script_folds_alike():
    sig = _fold_both(mtbf_script([30.0, 30.0, 30.0]), 300.0)
    assert sig.failures == 3 and sig.straggler_density == 1.0
    assert sig.mtbf_s == pytest.approx(100.0)


def test_link_quality_takes_each_replicas_counter_deltas():
    events = _telemetry(4, faults=(0, 0, 1, 0))
    assert _fold_both(events, 60.0).link_quality == pytest.approx(0.75)
    # a counter reset (a restart) counts no negative faults
    events.append({"ts_ms": 4000, "seq": 4, "kind": "telemetry", "replica_id": "r0",
                   "telemetry": {"rpc_retries": 0.0}})
    assert _fold_both(events, 60.0).link_quality == pytest.approx(0.8)


def test_fold_is_event_time_driven():
    events = churn_burst(4, period_s=5.0, start_ms=1_000_000)
    a = _fold_both(events, 60.0)
    time.sleep(0.01)
    assert _fold_both(events, 60.0) == a


def test_window_excludes_old_events():
    old = mtbf_script([10.0, 10.0], start_ms=0)
    recent = [{"ts_ms": 500_000, "seq": 99, "kind": "quorum", "quorum_id": 9,
               "participants": ["a", "b"]}]
    sig = _fold_both(old + recent, 60.0)
    assert (sig.failures, sig.events) == (0, 1)


@pytest.mark.parametrize("now_ms", [None, 0, 30_000, 61_000, 120_000, 200_000])
@pytest.mark.parametrize("window_s", [8.0, 60.0, 300.0])
def test_a_mixed_history_folds_alike(now_ms, window_s):
    _fold_both(_mixed_history(), window_s, now_ms)


# ----------------------------------------------------------------- engine
def _hysteresis_spec(pkg):
    return pkg.PolicySpec("t", [_rule(pkg, name="churny", threshold=6.0, release=2.0,
                                      actions={"TORCHFT_SYNC_EVERY": "64"})],
                          clamps={"TORCHFT_SYNC_EVERY": (1, 32)})


def test_engine_fires_holds_and_releases_alike():
    """Stepped along the same event times: the same frames, and the
    reference's fire, hold, release with policy_seq moving only on a
    change of the override set."""
    frames = {}
    for name, pkg in PACKAGES.items():
        eng = pkg.PolicyEngine(_hysteresis_spec(pkg), mode="observe", window_s=60.0)
        sets = [("ab" if i % 2 == 0 else "a") for i in range(9)]
        eng.feed(_quorum_events([(i * 1000, list(s)) for i, s in enumerate(sets)]))
        got = [eng.evaluate(now_ms=60_000), eng.evaluate(now_ms=61_000)]
        eng.feed(_quorum_events([(70_000 + i * 1000, list(s))
                                 for i, s in enumerate(["ab", "a", "ab", "a"])], seq0=100))
        got += [eng.evaluate(now_ms=130_000), eng.evaluate(now_ms=300_000)]
        frames[name] = (got, eng.flips)
    assert frames["torch"] == frames["jax"]
    got, flips = frames["torch"]
    assert [f["policy_seq"] for f in got] == [1, 1, 1, 2]
    assert got[0]["knob_overrides"] == {"TORCHFT_SYNC_EVERY": "32"}
    assert got[2]["active_rules"] == ["churny"] and got[3]["active_rules"] == []
    assert flips == 2


def test_the_later_rule_wins_a_shared_knob():
    frames = {}
    for name, pkg in PACKAGES.items():
        spec = pkg.PolicySpec("t", [
            _rule(pkg, name="first", threshold=0.1, release=0.0,
                  actions={"TORCHFT_SYNC_EVERY": "8"}),
            _rule(pkg, name="second", threshold=0.1, release=0.0,
                  actions={"TORCHFT_SYNC_EVERY": "128"})])
        eng = pkg.PolicyEngine(spec, mode="observe", window_s=60.0)
        eng.feed(_quorum_events([(0, ["a", "b"]), (1000, ["a"])]))
        frames[name] = eng.evaluate(now_ms=30_000)
    assert frames["torch"] == frames["jax"]
    assert frames["torch"]["knob_overrides"] == {"TORCHFT_SYNC_EVERY": "128"}


def test_bad_mode_is_refused():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.PolicyEngine(pkg.builtin_spec(), mode="yolo")


@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_builtin_frames_along_a_history_match(mode):
    """The builtin spec over the mixed history, fed in event order and
    evaluated every 2.5 s of event time: the same frame at every pass."""
    events = sorted(_mixed_history(), key=lambda e: (e["ts_ms"], e["seq"]))
    frames = {}
    for name, pkg in PACKAGES.items():
        eng = pkg.PolicyEngine(pkg.builtin_spec(), mode=mode, window_s=30.0)
        out, i = [], 0
        for now in range(0, 200_000, 2500):
            while i < len(events) and events[i]["ts_ms"] <= now:
                eng.feed([events[i]])
                i += 1
            out.append(eng.evaluate(now_ms=now))
        frames[name] = (out, eng.flips, eng.signals().to_dict())
    assert frames["torch"] == frames["jax"]
    assert frames["torch"][0][-1]["policy_seq"] > 1


# ------------------------------------------------------------- controller
def _controller_run(pkg, mode, batches, times, spec=None):
    published, retuned = [], []
    batches = list(batches)
    spec = spec or pkg.PolicySpec("t", [_rule(pkg, name="churny", threshold=6.0, release=2.0,
                                              actions={"TORCHFT_HEALTH_EJECT_Z": "9.0"})])
    ctl = pkg.PolicyController(pkg.PolicyEngine(spec, mode=mode, window_s=120.0),
                               drain_fn=lambda: batches.pop(0) if batches else [],
                               set_policy_fn=published.append, retune_health_fn=retuned.append)
    frames = [ctl.step(now_ms=t) for t in times]
    return frames, published, retuned


@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_the_controller_publishes_on_a_new_seq_and_retunes_in_enforce(mode):
    runs = {name: _controller_run(pkg, mode, [churn_burst(8, period_s=5.0), []],
                                  [50_000, 55_000, 400_000])
            for name, pkg in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    frames, published, retuned = runs["torch"]
    assert frames[0]["knob_overrides"] == {"TORCHFT_HEALTH_EJECT_Z": "9.0"}
    # fired, held (no republish), released
    assert [f["policy_seq"] for f in published] == [1, 2]
    # the release's frame names no health field: the ledger keeps 9.0
    assert retuned == ([{"eject_z": 9.0}] if mode == "enforce" else [])


def test_a_release_keeps_the_retuned_ledger_in_both_packages():
    """Shared with the reference: the released frame reverts the Managers'
    overrides, but the lighthouse ledger keeps the eject_z it was retuned to
    (no retune carries the default back)."""
    for name, pkg in PACKAGES.items():
        ledger = {"eject_z": 6.0}
        spec = pkg.PolicySpec("t", [_rule(pkg, name="churny", threshold=6.0, release=2.0,
                                          actions={"TORCHFT_HEALTH_EJECT_Z": "9.0",
                                                   "TORCHFT_HEALTH_EJECT_STEPS": "5"})])
        batches = [churn_burst(8, period_s=5.0)]
        ctl = pkg.PolicyController(pkg.PolicyEngine(spec, mode="enforce", window_s=120.0),
                                   drain_fn=lambda b=batches: b.pop(0) if b else [],
                                   set_policy_fn=lambda f: None,
                                   retune_health_fn=ledger.update)
        assert ctl.step(now_ms=50_000)["policy_seq"] == 1
        assert ledger == {"eject_z": 9.0, "eject_steps": 5}, name
        released = ctl.step(now_ms=400_000)
        assert released["policy_seq"] == 2 and released["knob_overrides"] == {}
        assert ledger == {"eject_z": 9.0, "eject_steps": 5}, name


# ------------------------------------------------------ replay and parity
def test_live_and_replayed_folds_agree(tmp_path):
    from torchft_tpu_torch.tracing import load_history

    events = churn_burst(8, period_s=5.0) + mtbf_script([15.0, 15.0, 15.0], start_ms=50_000,
                                                        seq0=100)
    gz = tmp_path / "run.jsonl.gz"
    gz.write_bytes(gzip.compress("\n".join(json.dumps(e) for e in events).encode()))
    live = policy.PolicyEngine(policy.builtin_spec(), mode="observe", window_s=300.0)
    for e in events:
        live.feed([e])
    replay = policy.PolicyEngine(policy.builtin_spec(), mode="observe", window_s=300.0)
    replay.feed(load_history(str(gz)))
    reference = ref.PolicyEngine(ref.builtin_spec(), mode="observe", window_s=300.0)
    reference.feed(events)
    assert live.signals().to_dict() == replay.signals().to_dict() == \
        reference.signals().to_dict()
    assert live.evaluate() == replay.evaluate() == reference.evaluate()


def _flappy(pkg):
    return pkg.PolicySpec("flappy", [_rule(pkg, name="hair-trigger", threshold=0.01,
                                           release=0.0, actions={"TORCHFT_SYNC_EVERY": "2"})])


@pytest.mark.parametrize("window_s, interval_s", [(300.0, 5.0), (30.0, 1.0), (8.0, 0.25)])
def test_scores_and_rankings_match(window_s, interval_s):
    events = _mixed_history()
    out = {name: pkg.rank_policies(events, [pkg.builtin_spec(), _flappy(pkg)],
                                   window_s=window_s, interval_s=interval_s)
           for name, pkg in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["score"] <= out["torch"][1]["score"]
    # the order of the candidates does not decide the ranking
    swapped = policy.rank_policies(events, [_flappy(policy), policy.builtin_spec()],
                                   window_s=window_s, interval_s=interval_s)
    assert [r["policy"] for r in swapped] == [r["policy"] for r in out["torch"]]


def test_score_counts_discarded_steps_and_flaps_alike():
    events = [
        {"ts_ms": 1000, "seq": 1, "kind": "heal", "replica_id": "r1", "from_step": 10,
         "to_step": 25},
        {"ts_ms": 2000, "seq": 2, "kind": "eject", "replica_id": "r2"},
        {"ts_ms": 3000, "seq": 3, "kind": "readmit", "replica_id": "r2"},
    ]
    rows = {name: pkg.score_policy(events, pkg.builtin_spec()) for name, pkg in PACKAGES.items()}
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]["components"]["discarded_steps"] == 15.0
    assert rows["torch"]["components"]["flapping"] >= 1.0


def _history_file(tmp_path):
    p = tmp_path / "hist.jsonl.gz"
    p.write_bytes(gzip.compress("\n".join(json.dumps(e) for e in _mixed_history()).encode()))
    return str(p)


def _candidate_file(tmp_path):
    p = tmp_path / "cand.json"
    p.write_text(json.dumps({"name": "aggressive", "rules": [
        {"name": "any-churn", "signal": "churn_per_min", "op": ">", "threshold": 0.5,
         "release": 0.1, "actions": {"TORCHFT_SYNC_EVERY": "128"}}]}))
    return str(p)


def _cli(module, *argv):
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("extra", [[], ["--json"], ["--window", "30", "--interval", "1"]],
                         ids=["text", "json", "window"])
def test_the_replay_cli_prints_what_the_reference_prints(tmp_path, extra):
    argv = ["replay", "--history", _history_file(tmp_path), "--policy", "builtin",
            _candidate_file(tmp_path), *extra]
    port, reference = _cli("torchft_tpu_torch.policy", *argv), _cli("torchft_tpu.policy", *argv)
    assert port.returncode == reference.returncode == 0, port.stderr[-2000:]
    assert port.stdout == reference.stdout
    if extra == ["--json"]:
        assert json.loads(port.stdout)["ranking"][0]["policy"] in ("builtin", "aggressive")
    else:
        assert "#1 " in port.stdout and "#2 " in port.stdout and "winner:" in port.stdout


@pytest.mark.parametrize("argv", [[], ["replay"], ["replay", "--history", "x"],
                                  ["replay", "--history", "x", "--policy"], ["score"]])
def test_replay_usage_errors_exit_2_alike(argv):
    port, reference = _cli("torchft_tpu_torch.policy", *argv), _cli("torchft_tpu.policy", *argv)
    assert port.returncode == reference.returncode == 2
    assert "usage: python -m torchft_tpu_torch.policy" in port.stderr


# --------------------------------------------------- wire + version skew
FRAME = {"policy_seq": 1, "mode": "observe", "knob_overrides": {"TORCHFT_SYNC_EVERY": "64"},
         "active_rules": ["churn-lengthen-sync"]}


def test_off_adds_no_reply_key_until_a_frame_is_published():
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
    try:
        assert lh.policy_controller is None and lh.policy_mode == "off"
        c = LighthouseClient(f"127.0.0.1:{lh.port}", retry_policy=NO_RETRY)
        plain = c.heartbeat("rep_a")
        assert "policy" not in plain
        # no ring: nothing to drain
        assert lh._policy_drain() == []
        lh.set_policy(FRAME)
        assert c.heartbeat("rep_a")["policy"] == FRAME and lh.policy() == FRAME
        lh.set_policy({})  # the kill switch
        again = c.heartbeat("rep_a")
        assert "policy" not in again and sorted(again) == sorted(plain)
        assert lh.policy() == {}
    finally:
        lh.shutdown()


def test_unknown_frame_keys_survive_the_aggregator_fanout():
    frame = {**FRAME, "policy_seq": 7, "epoch_hint": 99,
             "future_plan": {"stages": [1, 2, 3], "strategy": "v99"}}
    root = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
    agg = None
    try:
        root.set_policy(frame)
        agg = AggregatorServer(root_addr=f"127.0.0.1:{root.port}", bind="127.0.0.1:0",
                               agg_id="podZ", tick_ms=30)
        pod = LighthouseClient(f"127.0.0.1:{agg.port}", retry_policy=NO_RETRY)
        deadline = time.monotonic() + 10.0
        got = {}
        while not got and time.monotonic() < deadline:
            got = pod.heartbeat("rep_a").get("policy", {})
            time.sleep(0.05)
        assert got == frame
        q = pod.quorum("rep_a", 10.0)
        assert [m.replica_id for m in q.participants] == ["rep_a"]
    finally:
        if agg is not None:
            agg.shutdown()
        root.shutdown()


def test_an_agg_tick_with_unknown_params_still_lands():
    root = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
    try:
        c = _RawClient(f"127.0.0.1:{root.port}", retry_policy=NO_RETRY)
        resp = c.call("agg_tick", {"agg_id": "podF", "addr": "127.0.0.1:1", "epoch": 1,
                                   "seq": 1, "quorum_gen_seen": 0, "beats": ["r1"],
                                   "policy_ack_seq": 12, "shard_map_version": "v2"},
                      timeout=5.0, retry=False)
        assert "error" not in resp
        assert "podF" in c.call("status", {}, timeout=5.0, retry=False)["aggregators"]
    finally:
        root.shutdown()


@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_the_lighthouse_engine_publishes_the_calm_rule(monkeypatch, mode):
    """TORCHFT_POLICY on and the builtin spec: the lighthouse's own loop
    folds its ring and publishes the "calm" rule's frame at its first
    pass, on the beat reply and on /metrics."""
    import urllib.request

    monkeypatch.setenv("TORCHFT_POLICY", mode)
    monkeypatch.setenv("TORCHFT_POLICY_INTERVAL_S", "0.05")
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
    try:
        assert lh.policy_controller is not None and lh.policy_mode == mode
        c = LighthouseClient(f"127.0.0.1:{lh.port}", retry_policy=NO_RETRY)
        deadline = time.monotonic() + 10.0
        while not lh.policy() and time.monotonic() < deadline:
            time.sleep(0.02)
        frame = lh.policy()
        assert frame == {"policy_seq": 1, "mode": mode, "active_rules": ["calm-tighten-eject"],
                         "knob_overrides": {"TORCHFT_HEALTH_EJECT_Z": "5.0"}}
        assert c.heartbeat("rep_a")["policy"] == frame
        with urllib.request.urlopen(f"http://127.0.0.1:{lh.port}/metrics", timeout=5) as r:
            assert "torchft_lighthouse_policy_seq 1" in r.read().decode()
        opts = lh.retune_health({})
        assert opts["eject_z"] == (5.0 if mode == "enforce" else 6.0)
    finally:
        lh.shutdown()
    assert lh.policy_controller is None


# ------------------------------------------- manager quorum safe point
def _make_manager(package, lh_port, replica_id, **kw):
    if package == "jax":
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import ProcessGroupHost

        w = np.zeros(4, np.float32)
    else:
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupHost

        w = torch.zeros(4)
    return Manager(pg=ProcessGroupHost(timeout=10.0), load_state_dict=lambda sd: None,
                   state_dict=lambda: {"w": w}, min_replica_size=1, replica_id=replica_id,
                   lighthouse_addr=f"127.0.0.1:{lh_port}", timeout=10.0, quorum_timeout=5.0,
                   heartbeat_interval=0.05, **kw)


def _lighthouse(package):
    if package == "jax":
        from torchft_tpu.coordination import LighthouseServer as cls
    else:
        cls = LighthouseServer
    return cls(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)


POLICY_TIMINGS = ("policy_seq", "policy_applies", "policy_intents")

# (frame on the mirror, safe points it is polled at): the same seq twice,
# a frame in observe mode, an unregistered knob, a compress retarget, a
# release, an older seq, a malformed frame, and the kill switch
FRAME_SCRIPT = [
    ({"policy_seq": 1, "mode": "enforce", "active_rules": ["a"],
      "knob_overrides": {"TORCHFT_SYNC_EVERY": "64"}}, 2),
    ({"policy_seq": 2, "mode": "observe", "active_rules": ["a", "b"],
      "knob_overrides": {"TORCHFT_SYNC_EVERY": "64", "TORCHFT_HEALTH_EJECT_Z": "9.0"}}, 1),
    ({"policy_seq": 3, "mode": "enforce", "active_rules": ["a", "c"],
      "knob_overrides": {"TORCHFT_SYNC_EVERY": "32", "TORCHFT_NOT_A_KNOB": "1",
                         "TORCHFT_COMPRESS": "int8"}}, 2),
    ({"policy_seq": 4, "mode": "enforce", "active_rules": ["c"],
      "knob_overrides": {"TORCHFT_COMPRESS": "int8"}}, 1),
    ({"policy_seq": 2, "mode": "enforce", "active_rules": [],
      "knob_overrides": {"TORCHFT_SYNC_EVERY": "8"}}, 1),
    ({"policy_seq": "x", "mode": "enforce"}, 1),
    ({"policy_seq": 6, "mode": "enforce", "active_rules": [], "knob_overrides": {}}, 1),
    ({}, 1),
]


def _run_frame_script(package, mode, monkeypatch):
    """One Manager of ``package`` whose heartbeat mirror serves
    FRAME_SCRIPT's frames (its ManagerServer's ``policy`` stubbed), polled
    at start_quorum. Returns what each safe point left: the policy
    timings, the override layer, the adjuster calls and the codec."""
    if mode is None:
        monkeypatch.delenv("TORCHFT_POLICY", raising=False)
    else:
        monkeypatch.setenv("TORCHFT_POLICY", mode)
    lh = _lighthouse(package)
    manager = None
    calls = []
    try:
        manager = _make_manager(package, lh.port, f"pol_{package}")
        manager.register_policy_adjuster("TORCHFT_SYNC_EVERY", calls.append)
        current = [{}]
        manager._manager.policy = lambda: dict(current[0])
        layer = knobs if package == "torch" else ref_knobs
        seen = []
        for frame, polls in FRAME_SCRIPT:
            current[0] = frame
            for _ in range(polls):
                manager.start_quorum()
                manager.wait_quorum()
                t = manager.timings()
                seen.append(({k: t[k] for k in POLICY_TIMINGS}, layer.get_overrides(),
                             list(calls), manager._compress))
        return seen, manager.policy_status()
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        lh.shutdown()


@pytest.mark.parametrize("mode", [None, "off", "observe", "enforce"])
def test_the_safe_point_matches_the_reference_under_one_frame_script(mode, monkeypatch):
    port, port_status = _run_frame_script("torch", mode, monkeypatch)
    reference, ref_status = _run_frame_script("jax", mode, monkeypatch)
    assert port == reference
    assert port_status == ref_status
    last_timings, last_layer, last_calls, last_codec = port[-1]
    if mode in (None, "off"):
        # never polled: no counter, no knob, no adjuster
        assert all(t == (dict.fromkeys(POLICY_TIMINGS, 0.0), {}, [], "off") for t in port)
    elif mode == "observe":
        assert last_timings == {"policy_seq": 6.0, "policy_applies": 0.0, "policy_intents": 5.0}
        assert all(t[1] == {} and t[2] == [] for t in port)
    else:
        assert last_timings == {"policy_seq": 6.0, "policy_applies": 4.0, "policy_intents": 1.0}
        assert port[1][1] == {"TORCHFT_SYNC_EVERY": "64"}  # seq 1 applied once
        assert port[4][1] == {"TORCHFT_SYNC_EVERY": "32", "TORCHFT_COMPRESS": "int8"}
        assert port[4][3] == "int8"
        assert last_calls == ["64", "32", None]
        assert (last_layer, last_codec) == ({}, "off")


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_enforce_applies_then_reverts_through_a_live_lighthouse(package, monkeypatch):
    """The reference's round trip over a real lighthouse and heartbeat:
    overrides, the adjuster and the codec; the release undoes all three."""
    monkeypatch.setenv("TORCHFT_POLICY", "enforce")
    lh = _lighthouse(package)
    layer = knobs if package == "torch" else ref_knobs
    manager = None
    calls = []

    def poll_until(pred, msg):
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            manager.start_quorum()
            if pred(manager.timings()):
                return
            time.sleep(0.05)
        raise TimeoutError(f"{msg}: {manager.timings()}")

    try:
        manager = _make_manager(package, lh.port, f"pol_enf_{package}")
        manager.register_policy_adjuster("TORCHFT_SYNC_EVERY", calls.append)
        lh.set_policy({"policy_seq": 1, "mode": "enforce",
                       "knob_overrides": {"TORCHFT_SYNC_EVERY": "64", "TORCHFT_COMPRESS": "int8"},
                       "active_rules": ["churn-lengthen-sync", "flaky-links"]})
        poll_until(lambda t: t["policy_applies"] >= 1.0, "enforce apply")
        assert layer.get_overrides() == {"TORCHFT_SYNC_EVERY": "64", "TORCHFT_COMPRESS": "int8"}
        assert calls == ["64"] and manager._compress == "int8"
        manager.start_quorum()
        assert manager.timings()["policy_applies"] == 1.0
        lh.set_policy({"policy_seq": 2, "mode": "enforce", "knob_overrides": {},
                       "active_rules": []})
        poll_until(lambda t: t["policy_seq"] >= 2.0, "revert frame")
        assert layer.get_overrides() == {} and calls == ["64", None]
        assert manager._compress == "off"
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        lh.shutdown()


def test_the_policy_counters_reach_metrics(monkeypatch):
    import urllib.request

    monkeypatch.setenv("TORCHFT_POLICY", "observe")
    lh = _lighthouse("torch")
    manager = None
    try:
        manager = _make_manager("torch", lh.port, "pol_metrics", metrics_port=0)
        manager._manager.policy = lambda: dict(FRAME, policy_seq=3)
        manager.start_quorum()
        manager.wait_quorum()
        with urllib.request.urlopen(f"http://127.0.0.1:{manager.metrics_port}/metrics",
                                    timeout=5) as r:
            text = r.read().decode()
        assert "torchft_manager_policy_intents_total 1" in text
        assert "torchft_manager_policy_applies_total 0" in text
        assert "torchft_manager_policy_seq 3" in text
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        lh.shutdown()


@pytest.mark.parametrize("values", [
    ("3", "1", None, "0", "-4", "500", None),
    ("7", None, "64", "65"),
])
def test_the_redundancy_adjusters_clamp_as_the_reference(values):
    """The redundancy plane's two adjusters on the same sequence of frame
    values: the same cadence and parity count after each."""
    from torchft_tpu.manager import Manager as JaxManager
    from torchft_tpu.redundancy import RedundancyConfig as JaxConfig
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.redundancy import RedundancyConfig

    seen = {}
    for name, mgr_cls, cfg_cls in (("jax", JaxManager, JaxConfig),
                                   ("torch", Manager, RedundancyConfig)):
        m = mgr_cls.__new__(mgr_cls)
        m._redundancy_cfg = cfg_cls(k=250, m=2, directory="http://x", interval=4)
        m._policy_red_defaults = (4, 2)
        out = []
        for v in values:
            m._policy_set_red_interval(v)
            m._policy_set_red_m(v)
            out.append((m._redundancy_cfg.interval, m._redundancy_cfg.m))
        seen[name] = out
    assert seen["torch"] == seen["jax"]


def test_a_manager_with_the_redundancy_plane_registers_both_adjusters(monkeypatch):
    from torchft_tpu_torch.redundancy import RedundancyConfig, ShardDirectory

    lh = _lighthouse("torch")
    directory = ShardDirectory(lighthouse_addr=f"127.0.0.1:{lh.port}")
    manager = None
    try:
        manager = _make_manager("torch", lh.port, "pol_red", redundancy=RedundancyConfig(
            k=2, m=1, directory=directory.url, interval=3))
        assert manager.policy_status()["adjusters"] == ["TORCHFT_REDUNDANCY_INTERVAL",
                                                        "TORCHFT_REDUNDANCY_M"]
        manager._policy_adjusters["TORCHFT_REDUNDANCY_INTERVAL"]("1")
        manager._policy_adjusters["TORCHFT_REDUNDANCY_M"]("2")
        assert (manager._shard_stager.cfg.interval, manager._shard_stager.cfg.m) == (1, 2)
        manager._policy_adjusters["TORCHFT_REDUNDANCY_INTERVAL"](None)
        manager._policy_adjusters["TORCHFT_REDUNDANCY_M"](None)
        assert (manager._shard_stager.cfg.interval, manager._shard_stager.cfg.m) == (3, 1)
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        directory.shutdown()
        lh.shutdown()


# ----------------------------------------------- live cadence adjusters
class _StubManager:
    """The Manager surface LocalSGD's and DiLoCo's constructors need."""

    _use_async_quorum = False

    def __init__(self):
        self.adjusters = {}

    def register_policy_adjuster(self, knob, fn):
        self.adjusters[knob] = fn

    def register_state_dict_fn(self, name, load, save):
        pass

    def current_step(self):
        return 0

    def last_quorum_healed(self):
        return False


def test_local_sgd_takes_the_env_and_retargets_live_alike(monkeypatch):
    from torchft_tpu.local_sgd import LocalSGD as JaxLocalSGD
    from torchft_tpu_torch.local_sgd import LocalSGD

    monkeypatch.setenv("TORCHFT_SYNC_EVERY", "16")
    seen = {}
    for name, cls, params in (("jax", JaxLocalSGD, {"w": np.zeros(4, np.float32)}),
                              ("torch", LocalSGD, {"w": torch.zeros(4)})):
        mgr = _StubManager()
        sgd = cls(mgr, params, sync_every=8)
        out = [sgd.sync_every]
        adjust = mgr.adjusters["TORCHFT_SYNC_EVERY"]
        for v in ("4", "0", "-3", None, "128"):
            adjust(v)
            out.append(sgd.sync_every)
        seen[name] = out
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:5] == [16, 4, 1, 1, 16]


def test_diloco_queues_a_retarget_to_its_cycle_boundary_alike():
    import optax

    from torchft_tpu.local_sgd import DiLoCo as JaxDiLoCo
    from torchft_tpu_torch.local_sgd import DiLoCo

    def make(name):
        mgr = _StubManager()
        if name == "jax":
            params = {"a": np.zeros(8, np.float32), "b": np.zeros(8, np.float32)}
            return mgr, params, JaxDiLoCo(mgr, params, outer_tx=optax.sgd(0.7), sync_every=8,
                                          num_fragments=2)
        params = {"a": torch.zeros(8), "b": torch.zeros(8)}
        return mgr, params, DiLoCo(mgr, params, lambda ps: torch.optim.SGD(ps, lr=0.7),
                                   sync_every=8, num_fragments=2)

    seen = {}
    for name in ("jax", "torch"):
        mgr, params, dl = make(name)
        adjust = mgr.adjusters["TORCHFT_SYNC_EVERY"]
        out = [(dl.sync_every, dl._pending_sync_every)]
        adjust("4")  # 4 over 2 fragments: 2 a fragment, queued
        out.append((dl.sync_every, dl._pending_sync_every))
        dl.step(params)  # the boundary applies it before counting
        out.append((dl.sync_every, dl._pending_sync_every))
        adjust("1")  # clamped to one step a fragment
        out.append((dl.sync_every, dl._pending_sync_every))
        adjust(None)  # the constructor's cadence, queued
        out.append((dl.sync_every, dl._pending_sync_every))
        with pytest.raises(ValueError):
            dl.set_sync_every(7)  # the operator's API stays strict
        seen[name] = out
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == [(4, None), (4, 2), (2, None), (2, 1), (2, 4)]


# ------------------------------------------------------------- doctor
def test_the_doctors_churn_burst_is_the_reference_helpers():
    assert doctor.churn_burst(8, period_s=5.0) == churn_burst(8, period_s=5.0)
    assert doctor.churn_burst(3, 2.0, replicas=2) == churn_burst(3, 2.0, replicas=2)


def _bad_spec(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"name": "bad", "rules": [
        {"name": "r", "signal": "nope", "op": ">", "threshold": 1, "release": 0,
         "actions": {"X": "1"}}]}))
    return str(p)


def _good_spec(tmp_path):
    p = tmp_path / "good.json"
    p.write_text(json.dumps(policy.builtin_spec().to_json()))
    return str(p)


POLICY_ENV_CASES = {
    "defaults": ({}, True),
    "observe": ({"TORCHFT_POLICY": "observe"}, True),
    "enforce_from_a_file": ({"TORCHFT_POLICY": "enforce", "TORCHFT_POLICY_SPEC": _good_spec},
                            True),
    "bad_mode": ({"TORCHFT_POLICY": "yolo"}, False),
    "bad_spec": ({"TORCHFT_POLICY_SPEC": _bad_spec}, False),
    "missing_spec": ({"TORCHFT_POLICY_SPEC": lambda tmp: os.path.join(tmp, "none.json")}, False),
    "bad_window": ({"TORCHFT_POLICY_WINDOW_S": "five"}, False),
    "bad_ring": ({"TORCHFT_POLICY_RING": "4k"}, False),
    "bad_sync_every": ({"TORCHFT_SYNC_EVERY": "often"}, False),
}


@pytest.mark.parametrize("case", sorted(POLICY_ENV_CASES))
def test_policy_env_agrees_with_the_reference(case, monkeypatch, tmp_path):
    env, ok = POLICY_ENV_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value(tmp_path) if callable(value) else value)
    port, reference = doctor.check_policy_env(), ref_doctor.check_policy_env()
    assert port[0] is reference[0] is ok, (port, reference)
    assert port[1] == reference[1]
    if case == "defaults":
        assert "rule" in port[1]


# ------------------------------------- a codec retarget, one replica at a time
CODEC_STEPS = 4


def _codec_fleet(package):
    """Two replica threads of ``package``, ``compress="fp8"``, in enforce
    mode; each Manager's heartbeat mirror is stubbed to serve the frame
    ``{TORCHFT_COMPRESS: int8}`` from its own safe point on: replica 0's
    second, replica 1's third. Returns each replica's votes, allreduce
    results and codec per step."""
    if package == "jax":
        from torchft_tpu.coordination import LighthouseServer as lh_cls
        from torchft_tpu.manager import Manager as mgr_cls
        from torchft_tpu.process_group import ProcessGroupHost as pg_cls
    else:
        from torchft_tpu_torch.manager import Manager as mgr_cls
        from torchft_tpu_torch.process_group import ProcessGroupHost as pg_cls

        lh_cls = LighthouseServer
    lh = lh_cls(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000, quorum_tick_ms=20,
                heartbeat_timeout_ms=5000, health=HEALTH_OFF)
    barrier = threading.Barrier(2)
    frame = {"policy_seq": 1, "mode": "enforce", "active_rules": ["flaky-links-compress"],
             "knob_overrides": {"TORCHFT_COMPRESS": "int8"}}

    def replica(rid):
        manager = mgr_cls(pg=pg_cls(timeout=30.0), load_state_dict=lambda sd: None,
                          state_dict=lambda: {}, min_replica_size=2, replica_id=f"c{rid}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=30.0,
                          quorum_timeout=30.0, init_sync=False, compress="fp8")
        polls = [0]

        def mirror():
            polls[0] += 1
            return dict(frame) if polls[0] >= 2 + rid else {}

        manager._manager.policy = mirror
        try:
            out = []
            for step in range(CODEC_STEPS):
                barrier.wait(timeout=60)
                manager.start_quorum()
                rng = np.random.RandomState(100 * rid + step)
                g = (rng.randn(8, 3000) * np.exp(rng.randn(8, 1))).astype(np.float32)
                # two leaves: a tree of one leaf takes the serial path, which
                # codes only under should_quantize
                tree = {"a": g[:4], "b": g[4:]}
                grads = tree if package == "jax" else {k: torch.from_numpy(v)
                                                        for k, v in tree.items()}
                avg = manager.allreduce(grads).get_future().wait(60)
                vote = manager.should_commit()
                flat = np.concatenate([np.asarray(avg[k]) for k in ("a", "b")])
                out.append((vote, flat, manager._compress, g))
            return out
        except BaseException:
            barrier.abort()
            raise
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return [f.result(timeout=180) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def _same_bits(a, b):
    """Bitwise equal, but for the payload of a NaN: at the mixed step an
    int8 code read as an e4m3fn NaN decodes to numpy's NaN payload in the
    reference and torch's in the port (the same positions and signs)."""
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b)) and np.array_equal(np.signbit(a), np.signbit(b))
            and np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32)))


def test_a_codec_retarget_landing_replica_by_replica_matches_the_reference(monkeypatch):
    """The frame lands on replica 0 one safe point before replica 1, so
    one step reduces an int8 wire against an fp8 one (neither package's
    ring checks that the hops' codecs agree). Both packages vote the same
    and give the same bits, replica by replica and step by step; at the
    mixed step both commit a sum that is not the replicas' mean, and the two
    replicas hold different answers (ROADMAP queue 3, a fault shared with
    the reference)."""
    monkeypatch.setenv("TORCHFT_POLICY", "enforce")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reference = _codec_fleet("jax")
        ref_knobs.clear_overrides()
        port = _codec_fleet("torch")
    finally:
        torch.set_num_threads(n)
    for rid in range(2):
        assert [s[0] for s in port[rid]] == [s[0] for s in reference[rid]]
        assert [s[2] for s in port[rid]] == [s[2] for s in reference[rid]]
        for step in range(CODEC_STEPS):
            assert _same_bits(port[rid][step][1], reference[rid][step][1]), (rid, step)
    # replica 0 codes int8 from step 1, replica 1 from step 2
    assert [s[2] for s in port[0]] == ["fp8", "int8", "int8", "int8"]
    assert [s[2] for s in port[1]] == ["fp8", "fp8", "int8", "int8"]
    mean = [(port[0][s][3] + port[1][s][3]) / 2 for s in range(CODEC_STEPS)]
    err = [float(np.abs(port[0][s][1] - mean[s]).max() / np.abs(mean[s]).max())
           for s in range(CODEC_STEPS)]
    # the agreed codecs' steps are the mean within the codec's error
    assert max(err[0], err[2], err[3]) < 0.1, err
    # the mixed step commits on both replicas with neither the mean nor one
    # answer (replica 1's holds NaNs): the replicas part ways silently, in
    # both packages alike
    assert port[0][1][0] and port[1][1][0]
    assert err[1] > 1.0, err
    assert not _same_bits(port[0][1][1], port[1][1][1])
    assert np.isnan(port[1][1][1]).any() and not np.isnan(port[0][1][1]).any()


# ------------------------------------------------- the slice as a whole
def test_the_trainer_applies_and_releases_a_churn_frame(tmp_path, monkeypatch):
    """The trainer's two replica threads (debug Llama, fp8 streamed buckets,
    HTTP heal) under TORCHFT_POLICY=enforce with one churn rule: replica 1's
    crash and replacement (two membership units over the 5 s window, 24 a
    minute) fire it, the pre-crash quorum's leaving the window releases it.
    Both replicas apply seq 1 and seq 2 at their safe points, the override
    layer follows, the ledger keeps its retuned eject_z, and the recorded
    history scores and ranks the same in both packages."""
    from torchft_tpu_torch.tracing import load_history
    from torchft_tpu_torch.train import Fault, TrainConfig, run_replicas

    spec = {"name": "churn", "rules": [
        {"name": "churn", "signal": "churn_per_min", "op": ">", "threshold": 12.0,
         "release": 0.5, "actions": {"TORCHFT_HEALTH_EJECT_Z": "9.0"}}],
        "clamps": {"TORCHFT_HEALTH_EJECT_Z": [3.0, 12.0]}}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    for name, value in (("TORCHFT_POLICY", "enforce"), ("TORCHFT_POLICY_INTERVAL_S", "0.05"),
                        ("TORCHFT_POLICY_WINDOW_S", "5")):
        monkeypatch.setenv(name, value)
    latest, layers = {}, []
    lock = threading.Lock()
    set_override = knobs.set_override

    def recording_set_override(name, value):
        # the layer is the process's, shared by both replicas' Managers
        set_override(name, value)
        layers.append(knobs.get_overrides())

    monkeypatch.setattr(knobs, "set_override", recording_set_override)

    def on_step(e):
        with lock:
            latest[e["replica"]] = e["policy_seq"]

    def until(step):
        with lock:
            return len(latest) == 2 and set(latest.values()) == {2.0}

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fleet = {}
    try:
        results = run_replicas(
            TrainConfig(config="debug", seq_len=16, steps=5, replicas=2, quantize=True,
                        trace_dir=str(tmp_path), policy=str(spec_path),
                        faults=(Fault(1, 3, "crash", at="backward"),)),
            "cpu", on_step=on_step, fleet=fleet, until=until, max_steps=400)
    finally:
        torch.set_num_threads(n)
    assert fleet["policy"]["policy_seq"] == 2 and fleet["policy"]["knob_overrides"] == {}
    assert results[0]["step"] == results[1]["step"] < 400
    assert results[1]["restarts"] == 1 and results[0]["metrics"]["commit_failures"] >= 1
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
    # each Manager set it at seq 1 and cleared it at seq 2
    assert layers == [{"TORCHFT_HEALTH_EJECT_Z": "9.0"}] * 2 + [{}] * 2, layers
    assert knobs.get_overrides() == {}
    assert fleet["health"]["opts"]["eject_z"] == 9.0
    for r in results:
        assert r["timings"]["policy_seq"] == 2.0 and r["timings"]["policy_applies"] >= 2
        assert r["timings"]["policy_intents"] == 0
    history = load_history(str(tmp_path / "lighthouse_history.jsonl"))
    assert [e["opts"]["eject_z"] for e in history if e["kind"] == "health_retune"] == [9.0]
    ranked = {name: pkg.rank_policies(history, [pkg.builtin_spec(),
                                                pkg.PolicySpec.from_json(spec)],
                                      window_s=5.0, interval_s=0.05)
              for name, pkg in PACKAGES.items()}
    assert ranked["torch"] == ranked["jax"]
