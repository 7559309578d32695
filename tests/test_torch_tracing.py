"""The tracing plane of the port against the reference: ``TraceConfig``,
``step_sampled``, ``SpanRecorder`` (the same calls give the same exports in
both packages, clock stamps aside where the call takes the clock),
``merge_traces``, the recorded-history fold against the native
``history_replay``, the ``trace`` CLI, and the Manager's and the
lighthouse's ``/metrics`` (the counterparts of ``tests/test_tracing.py``).
"""

from __future__ import annotations

import json
import socket
import time
import urllib.request

import pytest
import torch

from torchft_tpu import trace as ref_trace_cli
from torchft_tpu import tracing as ref_tracing
from torchft_tpu_torch import trace as trace_cli
from torchft_tpu_torch import tracing
from torchft_tpu_torch.tracing import (
    SpanRecorder,
    TraceConfig,
    clear_clock_offsets,
    history_fold,
    merge_traces,
    parse_history,
    set_clock_offset_ms,
    step_sampled,
)

TRACE_ENVS = ("TORCHFT_TRACE", "TORCHFT_TRACE_BUFFER", "TORCHFT_TRACE_SAMPLE",
              "TORCHFT_TRACE_DIR")


@pytest.fixture(autouse=True)
def _clean_clock_offsets():
    yield
    clear_clock_offsets()
    ref_tracing.clear_clock_offsets()


def _cfg(mod=tracing, buffer=64, sample=1.0, enabled=True, dump_dir=""):
    return mod.TraceConfig(enabled=enabled, buffer=buffer, sample=sample, dump_dir=dump_dir)


def _parse_prometheus(text: str) -> dict:
    """name (labels included) -> value; raises on malformed exposition."""
    assert "# HELP" in text and "# TYPE" in text, text[:200]
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            series[name] = float(value)
    return series


def _bare_names(series: dict) -> set:
    return {k.split("{")[0] for k in series}


# ------------------------------------------------------------------- config
class TestTraceConfig:
    def test_defaults(self, monkeypatch):
        for env in TRACE_ENVS:
            monkeypatch.delenv(env, raising=False)
        cfg = TraceConfig.from_env()
        assert (cfg.enabled, cfg.buffer, cfg.sample, cfg.dump_dir) == (True, 4096, 1.0, "")
        assert vars(cfg) == vars(ref_tracing.TraceConfig.from_env())

    @pytest.mark.parametrize("val,expect", [
        ("0", False), ("off", False), ("false", False), ("no", False),
        ("1", True), ("on", True), ("yes", True), ("", True),
    ])
    def test_master_switch(self, monkeypatch, val, expect):
        monkeypatch.setenv("TORCHFT_TRACE", val)
        assert TraceConfig.from_env().enabled is expect
        assert ref_tracing.TraceConfig.from_env().enabled is expect

    @pytest.mark.parametrize("env,raw,field,expect", [
        ("TORCHFT_TRACE_BUFFER", "4", "buffer", 16),
        ("TORCHFT_TRACE_BUFFER", "lots", "buffer", 4096),
        ("TORCHFT_TRACE_BUFFER", "100", "buffer", 100),
        ("TORCHFT_TRACE_SAMPLE", "1.7", "sample", 1.0),
        ("TORCHFT_TRACE_SAMPLE", "-0.3", "sample", 0.0),
        ("TORCHFT_TRACE_SAMPLE", "half", "sample", 1.0),
        ("TORCHFT_TRACE_SAMPLE", "0.25", "sample", 0.25),
    ])
    def test_clamps_and_garbage_as_the_reference(self, monkeypatch, env, raw, field, expect):
        monkeypatch.setenv(env, raw)
        assert getattr(TraceConfig.from_env(), field) == expect
        assert getattr(ref_tracing.TraceConfig.from_env(), field) == expect

    def test_dump_dir(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TORCHFT_TRACE_DIR", str(tmp_path))
        assert TraceConfig.from_env().dump_dir == str(tmp_path)


class TestStepSampled:
    def test_extremes(self):
        assert all(step_sampled(s, 1.0) for s in range(100))
        assert not any(step_sampled(s, 0.0) for s in range(100))

    @pytest.mark.parametrize("sample", [0.1, 0.5, 0.9])
    def test_the_references_steps(self, sample):
        ours = [step_sampled(s, sample) for s in range(10000)]
        assert ours == [ref_tracing.step_sampled(s, sample) for s in range(10000)]
        assert abs(sum(ours) / len(ours) - sample) < 0.1


# ----------------------------------------------------------------- recorder
def _drive(mod, calls, **cfg):
    """The same recorder calls on ``mod``'s SpanRecorder; its export."""
    rec = mod.SpanRecorder("drive", _cfg(mod, **cfg))
    for method, args, kwargs in calls:
        getattr(rec, method)(*args, **kwargs)
    return rec


CALLS = [
    ("set_context", (), {"quorum_id": 3, "step": 0}),
    ("record", ("quorum_rpc", "quorum", 1_000_000, 1_000_250), {"attempt": 1}),
    ("set_skew", (4.5,), {"rtt_ms": 1.25, "samples": 7}),
    ("set_context", (), {"step": 1}),
    ("record", ("commit_vote", "commit", 1_001_000, 1_001_000), {"local": True}),
    ("set_context", (), {"quorum_id": 4, "step": 2}),
    ("record", ("wire", "allreduce", 1_002_000, 1_004_500), {"bucket": 0}),
    ("record", ("heal_recv", "heal", 1_005_000, 1_009_000), {}),
]


class TestSpanRecorder:
    @pytest.mark.parametrize("sample", [1.0, 0.5])
    @pytest.mark.parametrize("buffer", [16, 4096])
    def test_same_calls_give_the_references_export(self, sample, buffer):
        calls = CALLS + [("record", ("e", "rpc", 2_000_000 + i, 2_000_001 + i), {"i": i})
                         for i in range(20)]
        ours = _drive(tracing, calls, sample=sample, buffer=buffer)
        ref = _drive(ref_tracing, calls, sample=sample, buffer=buffer)
        assert ours.export() == ref.export()
        assert ours.stats() == ref.stats()

    def test_clocked_calls_match_the_reference_but_their_stamps(self):
        def calls(rec):
            rec.set_context(quorum_id=1, step=5)
            with rec.span("configure_prepare", cat="quorum", world=3):
                pass
            rec.instant("rpc_retry", cat="rpc", method="quorum", attempt=2)
            pc = time.perf_counter()
            rec.record_rel("pack", cat="allreduce", t0_pc=pc - 0.01, t1_pc=pc, bucket=1)

        exports = []
        for mod in (tracing, ref_tracing):
            rec = mod.SpanRecorder("clocked", _cfg(mod))
            calls(rec)
            exports.append([{k: v for k, v in s.items() if k not in ("ts_us", "dur_us")}
                            for s in rec.export()["spans"]])
        assert exports[0] == exports[1]

    def test_span_context_stamps_context_and_args(self):
        rec = SpanRecorder("ctx", _cfg())
        rec.set_context(quorum_id=7, step=3)
        with rec.span("quorum_rpc", cat="quorum", attempt=2):
            pass
        (span,) = rec.export()["spans"]
        assert (span["name"], span["cat"], span["quorum_id"], span["step"]) == (
            "quorum_rpc", "quorum", 7, 3)
        assert span["args"] == {"attempt": 2} and span["dur_us"] >= 1

    def test_ring_bound_counts_drops_honestly(self):
        rec = SpanRecorder("ring", _cfg(buffer=16))
        for i in range(40):
            rec.instant("e", cat="rpc", i=i)
        assert rec.stats() == {"spans": 16.0, "recorded": 40.0, "dropped": 24.0}
        assert [s["args"]["i"] for s in rec.export()["spans"]] == list(range(24, 40))

    def test_disabled_is_a_noop(self):
        rec = SpanRecorder("off", _cfg(enabled=False))
        with rec.span("x", cat="quorum"):
            pass
        rec.instant("y", cat="rpc")
        rec.record_rel("z", cat="allreduce", t0_pc=0.0, t1_pc=1.0)
        assert rec.stats() == {"spans": 0.0, "recorded": 0.0, "dropped": 0.0}

    def test_record_rel_anchors_to_wall_clock(self):
        rec = SpanRecorder("rel", _cfg())
        now_pc = time.perf_counter()
        now_us = time.time_ns() // 1000
        rec.record_rel("w", cat="allreduce", t0_pc=now_pc - 0.05, t1_pc=now_pc, bucket=1)
        (span,) = rec.export()["spans"]
        assert abs(span["dur_us"] - 50_000) < 20_000
        assert abs((span["ts_us"] + span["dur_us"]) - now_us) < 30_000

    def test_injected_offset_shifts_clock_and_exported_skew(self):
        set_clock_offset_ms("offrep", 250.0)
        rec = SpanRecorder("offrep", _cfg())
        rec.set_skew(5.0, rtt_ms=2.0, samples=3)
        rec.instant("tick", cat="rpc")
        wall_us = time.time_ns() // 1000
        export = rec.export()
        assert export["skew_ms"] == pytest.approx(255.0)
        assert (export["rtt_ms"], export["skew_samples"]) == (2.0, 3)
        assert abs(export["spans"][0]["ts_us"] - (wall_us + 250_000)) < 50_000
        set_clock_offset_ms("fleet", 100.0)
        assert SpanRecorder("fleet_3", _cfg()).export()["skew_ms"] == 100.0
        assert SpanRecorder("other", _cfg()).export()["skew_ms"] == 0.0

    def test_dump_round_trip_and_destinations(self, tmp_path, monkeypatch):
        rec = SpanRecorder("dumper", _cfg())
        rec.instant("tick", cat="rpc")
        path = rec.dump(tmp_path / "deep" / "nest" / "d.json")
        loaded = json.loads(path.read_text())
        assert (loaded["replica_id"], loaded["clock"], len(loaded["spans"])) == (
            "dumper", "epoch_us", 1)
        monkeypatch.delenv("TORCHFT_FR_BASE_PATH", raising=False)
        assert SpanRecorder("nowhere", _cfg()).dump() is None
        path = SpanRecorder("dirrep", _cfg(dump_dir=str(tmp_path))).dump()
        assert path.parent == tmp_path and path.name.startswith("trace_dirrep_")
        monkeypatch.setenv("TORCHFT_FR_BASE_PATH", str(tmp_path / "fr"))
        assert SpanRecorder("frrep", _cfg()).dump().parent == tmp_path / "fr_traces"
        # a directory as the target: None, not an exception
        assert rec.dump(tmp_path) is None


# -------------------------------------------------------------------- merge
def _dump(rid, skew_ms, spans):
    return {"replica_id": rid, "clock": "epoch_us", "skew_ms": skew_ms, "rtt_ms": 0.0,
            "skew_samples": 1, "dropped": 0, "spans": spans}


class TestMergeTraces:
    def test_structure_and_skew_shift_as_the_reference(self):
        span = {"name": "x", "cat": "quorum", "ts_us": 1_000_000, "dur_us": 10, "quorum_id": 1,
                "step": 2, "args": {"k": "v"}}
        dumps = [_dump("bbb", 100.0, [span, dict(span, name="y", cat="commit")]),
                 _dump("aaa", -50.0, [dict(span, cat="heal")]),
                 _dump("ccc", 0.0, [])]
        trace = merge_traces(dumps)
        assert trace == ref_tracing.merge_traces(dumps)
        evs = trace["traceEvents"]
        procs = {e["args"]["name"]: e["pid"] for e in evs if e["name"] == "process_name"}
        assert procs == {"aaa (skew -50.000ms)": 0, "bbb (skew +100.000ms)": 1,
                         "ccc (skew +0.000ms)": 2}
        xs = {(e["args"]["replica_id"], e["name"]): e for e in evs if e["ph"] == "X"}
        assert xs[("bbb", "x")]["ts"] == 1_000_000 - 100_000
        assert xs[("aaa", "x")]["ts"] == 1_000_000 + 50_000
        assert xs[("bbb", "x")]["args"] == {"k": "v", "quorum_id": 1, "step": 2,
                                            "replica_id": "bbb"}

    def test_skewed_clocks_reorder_raw_but_not_merged(self):
        set_clock_offset_ms("skewfast", 1500.0)
        set_clock_offset_ms("skewslow", -1500.0)
        fast, slow = SpanRecorder("skewfast", _cfg()), SpanRecorder("skewslow", _cfg())
        for r in (fast, slow):
            r.set_context(quorum_id=1, step=1)
        fast.instant("mark", cat="quorum")
        time.sleep(0.12)
        slow.instant("mark", cat="quorum")
        d_fast, d_slow = fast.export(), slow.export()
        assert d_slow["spans"][0]["ts_us"] < d_fast["spans"][0]["ts_us"] - 1_000_000
        ts = {e["args"]["replica_id"]: e["ts"] for e in merge_traces([d_fast, d_slow])["traceEvents"]
              if e["ph"] == "X"}
        gap_us = ts["skewslow"] - ts["skewfast"]
        assert 0 < gap_us and abs(gap_us - 120_000) < 100_000, gap_us


# ------------------------------------------------------------------ history
_HISTORY_EVENTS = [
    {"kind": "quorum", "quorum_id": 1, "step": 0, "ts_ms": 1000, "participants": ["r0", "r1"]},
    {"kind": "heal", "replica_id": "r1", "to_step": 5, "ts_ms": 2000},
    {"kind": "straggler_warn", "replica_id": "r2", "ts_ms": 2500},
    {"kind": "eject", "replica_id": "r2", "ts_ms": 3000},
    {"kind": "readmit", "replica_id": "r2", "ts_ms": 4000},
    {"kind": "telemetry", "replica_id": "r0", "step": 7, "ts_ms": 4500},
    {"kind": "quorum", "quorum_id": 2, "step": 7, "ts_ms": 5000,
     "participants": ["r0", "r1", "r2"]},
    {"no_kind_at_all": True},
]


class TestHistory:
    def test_parse_history_skips_blanks(self):
        text = "\n" + json.dumps({"kind": "quorum"}) + "\n\n" + json.dumps({"kind": "heal"}) + "\n  \n"
        assert [e["kind"] for e in parse_history(text)] == ["quorum", "heal"]
        assert parse_history(text) == ref_tracing.parse_history(text)

    def test_fold_covers_every_field_as_the_reference(self):
        summary = history_fold(_HISTORY_EVENTS)
        assert summary == ref_tracing.history_fold(_HISTORY_EVENTS)
        assert summary["count"] == 8
        assert summary["kinds"] == {"quorum": 2, "heal": 1, "straggler_warn": 1, "eject": 1,
                                    "readmit": 1, "telemetry": 1, "unknown": 1}
        assert summary["replicas"] == ["r0", "r1", "r2"]
        assert (summary["quorum_transitions"], summary["last_quorum_id"], summary["heals"],
                summary["ejections"], summary["readmissions"], summary["warns"],
                summary["max_step"], summary["first_ts_ms"], summary["last_ts_ms"]) == (
            2, 2, 1, 1, 1, 1, 7, 1000, 5000)

    @pytest.mark.parametrize("gz", [False, True])
    def test_native_replay_matches_python_fold(self, tmp_path, gz):
        import gzip

        from torchft_tpu_torch import coordination

        text = "\n".join(json.dumps(e) for e in _HISTORY_EVENTS) + "\n\n"
        native = coordination.history_replay(text)
        assert native["summary"] == history_fold(parse_history(text))
        assert len(native["events"]) == len(_HISTORY_EVENTS)
        path = tmp_path / ("h.jsonl.gz" if gz else "h.jsonl")
        path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
        assert coordination.history_replay(str(path))["summary"] == native["summary"]
        assert tracing.load_history(str(path)) == ref_tracing.load_history(str(path))


# ---------------------------------------------------------------------- CLI
class TestTraceCLI:
    @pytest.mark.parametrize("argv", [
        [], ["merge"], ["merge", "out.json"], ["history"], ["history", "a", "b"], ["bogus"],
    ])
    def test_usage(self, argv, capsys):
        assert trace_cli.main(argv) == 2
        assert "usage:" in capsys.readouterr().err

    def test_merge_writes_the_references_chrome_trace(self, tmp_path, capsys):
        paths = []
        for i, rid in enumerate(("r0", "r1")):
            rec = SpanRecorder(rid, _cfg())
            rec.set_context(quorum_id=1, step=1)
            rec.record("tick", "quorum", 1_000 + i, 2_000 + i)
            paths.append(str(rec.dump(tmp_path / f"{rid}.json")))
        out, ref_out = tmp_path / "fleet.json", tmp_path / "ref_fleet.json"
        assert trace_cli.main(["merge", str(out), *paths]) == 0
        assert "merged 2 replica dumps" in capsys.readouterr().out
        assert ref_trace_cli.main(["merge", str(ref_out), *paths]) == 0
        assert json.loads(out.read_text()) == json.loads(ref_out.read_text())
        rids = {e["args"]["replica_id"] for e in json.loads(out.read_text())["traceEvents"]
                if e["ph"] == "X"}
        assert rids == {"r0", "r1"}

    def test_history_prints_fold(self, tmp_path, capsys):
        p = tmp_path / "history.jsonl"
        p.write_text("\n".join(json.dumps(e) for e in _HISTORY_EVENTS))
        assert trace_cli.main(["history", str(p)]) == 0
        assert json.loads(capsys.readouterr().out) == history_fold(_HISTORY_EVENTS)

    def test_module_runs_as_a_script(self, tmp_path):
        import subprocess
        import sys

        p = tmp_path / "history.jsonl"
        p.write_text("\n".join(json.dumps(e) for e in _HISTORY_EVENTS))
        out = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.trace", "history", str(p)],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["ejections"] == 1


# ------------------------------------------------- live endpoints + history
def _manager(lh, **kw):
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    return Manager(pg=ProcessGroupHost(timeout=10.0), load_state_dict=lambda sd: None,
                   state_dict=lambda: {"w": torch.zeros(4)}, min_replica_size=1,
                   lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=10.0,
                   heartbeat_interval=0.05, **kw)


def test_manager_and_lighthouse_metrics_serve_prometheus(tmp_path):
    """Both /metrics endpoints serve Prometheus text with the reference's
    series, and the lighthouse's recorded history replays through the
    native read path as the Python fold reads it."""
    from torchft_tpu_torch import coordination
    from torchft_tpu_torch.coordination import LighthouseServer

    hist_path = tmp_path / "history.jsonl"
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=200,
                          quorum_tick_ms=20, heartbeat_timeout_ms=2000,
                          history_path=str(hist_path))
    manager = _manager(lh, replica_id="metrics_probe", tracing=True, metrics_port=0)
    try:
        for _ in range(3):
            manager.start_quorum()
            manager.allreduce({"w": torch.ones(4)}).get_future().wait(30)
            manager.should_commit()
        with urllib.request.urlopen(f"http://127.0.0.1:{manager.metrics_port}/metrics",
                                    timeout=5.0) as resp:
            mgr_series = _parse_prometheus(resp.read().decode())
        names = _bare_names(mgr_series)
        assert mgr_series["torchft_manager_step"] >= 3
        assert mgr_series["torchft_manager_commits_total"] >= 1
        assert mgr_series["torchft_manager_trace_spans_total"] > 0
        assert mgr_series["torchft_manager_ejections_total"] == 0.0
        assert "torchft_manager_dropped_events_total" in names
        assert "torchft_manager_clock_skew_ms" in names
        assert "torchft_manager_wire_bytes_sent_total" in names
        assert "torchft_manager_health_state" in names
        assert any(n.startswith("torchft_manager_") and n.endswith("_seconds_bucket")
                   for n in names), names
        with urllib.request.urlopen(f"http://127.0.0.1:{lh.port}/metrics", timeout=5.0) as resp:
            lh_series = _parse_prometheus(resp.read().decode())
        lh_names = _bare_names(lh_series)
        assert lh_series["torchft_lighthouse_fleet_size"] >= 1
        assert {"torchft_lighthouse_quorum_id", "torchft_lighthouse_heartbeat_age_ms"} <= lh_names
        assert lh_series["torchft_lighthouse_history_events_total"] >= 1
        # the spans the Manager recorded of its three steps
        names = {s["name"] for s in manager.tracer.export()["spans"]}
        assert {"quorum_rpc", "configure_prepare", "commit_vote"} <= names, names
    finally:
        manager.shutdown(wait=False)
        lh.shutdown()
    events = parse_history(hist_path.read_text())
    assert any(e.get("kind") == "quorum" for e in events), events
    native = coordination.history_replay(hist_path.read_text())
    assert native["summary"] == history_fold(events)
    assert native["summary"]["quorum_transitions"] >= 1


def test_manager_survives_metrics_port_in_use(monkeypatch):
    """A port already bound (two Managers on a host with a fixed
    TORCHFT_METRICS_PORT): the Manager warns and trains without /metrics."""
    from torchft_tpu_torch.coordination import LighthouseServer

    blocker = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    monkeypatch.setenv("TORCHFT_METRICS_PORT", str(blocker.getsockname()[1]))
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=200,
                          quorum_tick_ms=20, heartbeat_timeout_ms=2000)
    manager = None
    try:
        manager = _manager(lh, replica_id="metrics_port_clash", tracing=False)
        assert manager.metrics_port is None
        manager.start_quorum()
        manager.allreduce({"w": torch.ones(4)}).get_future().wait(30)
        assert manager.should_commit()
        # tracing=False over TORCHFT_TRACE's default
        assert manager.tracer.stats()["recorded"] == 0.0
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        lh.shutdown()
        blocker.close()
