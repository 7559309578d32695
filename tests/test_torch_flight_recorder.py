"""The port's flight recorder against the reference's (the counterparts of
``tests/test_flight_recorder.py``): the ring's bound, the capacity knob,
per-quorum dump paths that never collide, the host process group's abort
dump, and the Manager's dumps on a reported error and on an ejection."""

from __future__ import annotations

import json
import threading

import pytest
import torch

import torchft_tpu.flight_recorder as ref_fr
import torchft_tpu_torch.flight_recorder as fr_mod
from torchft_tpu_torch.flight_recorder import FR_BASE_PATH_ENV, FR_CAPACITY_ENV, FlightRecorder


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("capacity,records", [(16, 20), (16, 5), (64, 200)])
def test_ring_buffer_bounded_as_the_reference(capacity, records):
    ours, ref = FlightRecorder(capacity=capacity), ref_fr.FlightRecorder(capacity=capacity)
    for rec in (ours, ref):
        for i in range(records):
            rec.record("collective", op="allreduce", i=i)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "time"} for e in evs]  # noqa: E731
    assert strip(ours._events) == strip(ref._events)
    assert len(ours._events) == min(capacity, records)
    assert ours._events[0]["i"] == max(0, records - capacity)
    assert ours._events[-1]["i"] == records - 1


@pytest.mark.parametrize("raw,expect", [("not_a_number", 2048), ("-5", 16), ("512", 512), ("", 2048)])
def test_env_capacity_tolerates_garbage(monkeypatch, raw, expect):
    monkeypatch.setenv(FR_CAPACITY_ENV, raw)
    assert fr_mod._env_capacity() == expect == ref_fr._env_capacity()


def test_dump_disabled_without_env(monkeypatch):
    monkeypatch.delenv(FR_BASE_PATH_ENV, raising=False)
    fr = FlightRecorder(capacity=16)
    fr.record("x")
    assert fr.dump() is None and fr.dump_path() is None


def test_dump_per_quorum_path_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv(FR_BASE_PATH_ENV, str(tmp_path / "fr"))
    paths = []
    for mod in (fr_mod, ref_fr):
        fr = mod.FlightRecorder(capacity=16)
        fr.record("quorum_reconfigure", quorum_id=7, replica="replica_a")
        fr.record("collective", op="allreduce", rank=0, world=2)
        path = fr.dump(reason="test", quorum_id=7, tag=f"{mod.__name__}_replica_a_0")
        assert path.parent.name == "fr_quorum_7"
        assert path.name.startswith(f"{mod.__name__}_replica_a_0_")
        paths.append(path)
    ours, ref = (_events(p) for p in paths)
    assert [e["kind"] for e in ours] == [e["kind"] for e in ref] == [
        "quorum_reconfigure", "collective", "dump"]
    assert [e["seq"] for e in ours] == [e["seq"] for e in ref] == [1, 2, 3]
    assert ours[-1]["reason"] == "test"


def test_same_tag_dumps_never_collide(tmp_path, monkeypatch):
    monkeypatch.setenv(FR_BASE_PATH_ENV, str(tmp_path / "fr"))
    fr = FlightRecorder(capacity=16)
    fr.record("manager_error", error="first")
    p1 = fr.dump(reason="manager_error", quorum_id=7, tag="rep_a_0_s5_manager_error")
    fr.record("manager_error", error="second")
    p2 = fr.dump(reason="manager_error", quorum_id=7, tag="rep_a_0_s5_manager_error")
    assert p1 != p2 and p1.exists() and p2.exists()
    assert p1.parent == p2.parent == tmp_path / "fr_quorum_7"
    first = _events(p1)
    assert any(e.get("error") == "first" for e in first)
    assert not any(e.get("error") == "second" for e in first)


def test_pg_abort_dumps(tmp_path, monkeypatch):
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost

    monkeypatch.setenv(FR_BASE_PATH_ENV, str(tmp_path / "fr"))
    fresh = FlightRecorder(capacity=64)
    monkeypatch.setattr(fr_mod, "recorder", fresh)
    store = KvStoreServer("127.0.0.1:0")
    pg = ProcessGroupHost(timeout=5.0)
    try:
        pg.configure(f"127.0.0.1:{store.port}/x", 0, 1)
        pg.allreduce([torch.ones(2)]).get_future().wait()
        pg.abort()
        dump_dir = fresh.dump_path().parent
        (dump,) = list(dump_dir.iterdir())
        events = _events(dump)
        assert any(e["kind"] == "pg_abort" for e in events)
        assert any(e["kind"] == "collective" and e["op"] == "allreduce" for e in events)
        # a second abort lands in a new file
        pg.abort()
        assert len(list(dump_dir.iterdir())) == 2
    finally:
        pg.shutdown()
        store.shutdown()


def _manager_shell():
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.tracing import SpanRecorder, TraceConfig

    m = Manager.__new__(Manager)
    m._errored = None
    m._replica_id = "rep_a"
    m._group_rank = 1
    m._step = 5
    m._quorum_id = 7
    m._metrics_lock = threading.Lock()
    m._metrics = {"errors": 0}
    m._timings = {}
    m._tracer = SpanRecorder("rep_a", TraceConfig(enabled=True, buffer=64))
    m._last_health_state = None
    return m


def test_manager_failure_dump_tags_carry_step_and_reason(tmp_path, monkeypatch):
    monkeypatch.setenv(FR_BASE_PATH_ENV, str(tmp_path / "fr"))
    monkeypatch.setattr(fr_mod, "recorder", FlightRecorder(capacity=64))
    m = _manager_shell()
    m.report_error(RuntimeError("boom"))
    m.report_error(RuntimeError("boom again"))
    dumps = sorted((tmp_path / "fr_quorum_7").iterdir())
    assert len(dumps) == 2
    for p in dumps:
        assert p.name.startswith("rep_a_1_s5_manager_error_"), p.name
    assert [e["kind"] for e in _events(dumps[1])] == ["manager_error", "dump", "manager_error", "dump"]
    assert m._metrics["errors"] == 1


def test_manager_health_transitions_leave_breadcrumbs_and_an_eject_dump(tmp_path, monkeypatch):
    monkeypatch.setenv(FR_BASE_PATH_ENV, str(tmp_path / "fr"))
    fresh = FlightRecorder(capacity=64)
    monkeypatch.setattr(fr_mod, "recorder", fresh)
    m = _manager_shell()
    for state, code in (("ok", 0), ("warn", 1), ("ejected", 2), ("ejected", 2),
                        ("probation", 3), ("ok", 0)):
        m._observe_health({"state": state, "state_code": code, "score": 7.5, "ejections": 1,
                           "readmissions": 0})
    kinds = [e["kind"] for e in fresh._events]
    assert [k for k in kinds if k != "dump"] == ["straggler_warn", "eject", "readmit", "recovered"]
    (eject_dump,) = [p for p in (tmp_path / "fr_quorum_7").iterdir() if "_eject_" in p.name]
    assert eject_dump.name.startswith("rep_a_1_s5_eject_")
    # the span ring beside it
    (trace,) = [p for p in (tmp_path / "fr_quorum_7").iterdir() if p.name.startswith("trace_")]
    spans = json.loads(trace.read_text())["spans"]
    assert [s["name"] for s in spans] == ["straggler_warn", "eject"]
    assert m._timings["health_state"] == 0.0 and m._timings["ejections"] == 1.0
