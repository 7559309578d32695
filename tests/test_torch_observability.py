"""The port's structured event streams, its async drain, its profiler
ranges and its ``/metrics`` against the reference (the counterparts of
``tests/test_observability.py``): the loggers' fields, the drain's bound
and its ``dropped`` count, the Manager's error event and honesty counters,
and ``MetricsRegistry`` / ``MetricsServer`` text equal byte for byte to
the reference's on the same registry calls."""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from torchft_tpu import observability as ref_obs
from torchft_tpu_torch import observability as obs
from torchft_tpu_torch.observability import (
    COMMIT_EVENTS,
    ERROR_EVENTS,
    HEALTH_EVENTS,
    QUORUM_EVENTS,
    TIMING_EVENTS,
    EventDrain,
    MetricsRegistry,
    MetricsServer,
    get_event_logger,
    trace_span,
)


def _capture(caplog, name, fn, **fields):
    with caplog.at_level(logging.INFO, logger=name):
        fn(**fields)
    records = [r for r in caplog.records if r.name == name]
    assert len(records) == 1
    payload = json.loads(records[0].getMessage())
    assert "event_time" in payload
    return payload


@pytest.mark.parametrize("stream,fn_name", [
    (QUORUM_EVENTS, "log_quorum_event"),
    (COMMIT_EVENTS, "log_commit_event"),
    (ERROR_EVENTS, "log_error_event"),
    (TIMING_EVENTS, "log_timing_event"),
    (HEALTH_EVENTS, "log_health_event"),
])
def test_streams_carry_the_references_fields(caplog, stream, fn_name):
    fields = dict(quorum_id=3, replica_rank=1, step=7, committed=True, error=ValueError("boom"))
    ours = _capture(caplog, stream, getattr(obs, fn_name), **fields)
    caplog.clear()
    ref = _capture(caplog, stream, getattr(ref_obs, fn_name), **fields)
    assert ours.pop("event_time") <= ref.pop("event_time")
    assert ours == ref
    assert ours["quorum_id"] == 3 and ours["committed"] is True and "boom" in ours["error"]


def test_stream_names_are_the_references():
    for name in ("QUORUM_EVENTS", "COMMIT_EVENTS", "ERROR_EVENTS", "TIMING_EVENTS",
                 "HEALTH_EVENTS", "POLICY_EVENTS", "ALLREDUCE_PIPELINE_PHASE",
                 "DEFAULT_TIME_BUCKETS", "METRICS_PORT_ENV"):
        assert getattr(obs, name) == getattr(ref_obs, name), name


def test_event_logger_cached():
    assert get_event_logger("x_stream") is get_event_logger("x_stream")


def test_otel_is_a_noop_without_the_sdk(caplog, monkeypatch):
    monkeypatch.setenv("TORCHFT_USE_OTEL", "1")
    monkeypatch.setattr(obs, "_otel_loggers", {})
    payload = _capture(caplog, COMMIT_EVENTS, obs.log_commit_event, step=1)
    assert payload["step"] == 1
    try:
        import opentelemetry.sdk  # noqa: F401
    except ImportError:
        assert obs._otel_loggers[COMMIT_EVENTS] is None


def test_trace_span_is_record_function():
    assert trace_span is torch.profiler.record_function
    with trace_span("torchft::test::span"):
        x = 1 + 1
    assert x == 2

    @obs.traced("torchft::test::fn")
    def fn(a, b=1):
        """doc"""
        return a + b

    assert fn(1, b=2) == 3 and fn.__name__ == "fn" and fn.__doc__ == "doc"


def test_manager_ranges_land_in_the_profilers_trace():
    @obs.traced("torchft::manager::wait_quorum")
    def wait():
        return torch.ones(4).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_span("torchft::manager::should_commit"):
            wait()
    names = {e.key for e in prof.key_averages()}
    assert {"torchft::manager::wait_quorum", "torchft::manager::should_commit"} <= names


# ------------------------------------------------------------------- drain
class TestEventDrain:
    def test_flush_inline_without_worker(self, caplog):
        drain = EventDrain(autostart=False)
        for i in range(3):
            assert drain.submit(COMMIT_EVENTS, {"step": i, "committed": True})
        with caplog.at_level(logging.INFO, logger=COMMIT_EVENTS):
            assert drain.flush()
        records = [r for r in caplog.records if r.name == COMMIT_EVENTS]
        assert [json.loads(r.getMessage())["step"] for r in records] == [0, 1, 2]

    def test_worker_drains_and_flush_blocks_until_written(self, caplog):
        drain = EventDrain()
        with caplog.at_level(logging.INFO, logger=TIMING_EVENTS):
            for i in range(5):
                assert drain.submit(TIMING_EVENTS, {"phase": "t", "i": i})
            assert drain.flush(timeout=10)
        assert len([r for r in caplog.records if r.name == TIMING_EVENTS]) == 5

    @pytest.mark.parametrize("maxsize,submitted", [(2, 3), (4, 10), (1, 1)])
    def test_bound_drops_the_newest_and_counts_as_the_reference(self, maxsize, submitted):
        ours, ref = EventDrain(maxsize, autostart=False), ref_obs.EventDrain(maxsize, autostart=False)
        got = [ours.submit(COMMIT_EVENTS, {"step": i}) for i in range(submitted)]
        assert got == [ref.submit(COMMIT_EVENTS, {"step": i}) for i in range(submitted)]
        assert got == [i < maxsize for i in range(submitted)]
        assert ours.dropped == ref.dropped == max(0, submitted - maxsize)
        assert ours.flush() and ref.flush()

    def test_bad_event_does_not_kill_drain(self, caplog):
        drain = EventDrain(autostart=False)
        drain.submit(COMMIT_EVENTS, {"bad": object()})
        drain.submit(COMMIT_EVENTS, {"step": 1})
        with caplog.at_level(logging.INFO, logger=COMMIT_EVENTS):
            assert drain.flush()
        assert len([r for r in caplog.records if r.name == COMMIT_EVENTS]) == 2

    def test_process_wide_singleton(self, caplog):
        assert obs.get_event_drain() is obs.get_event_drain()
        with caplog.at_level(logging.INFO, logger=HEALTH_EVENTS):
            assert obs.emit_event_async(HEALTH_EVENTS, kind="eject", replica_id="r")
            assert obs.get_event_drain().flush(timeout=10)
        assert any(json.loads(r.getMessage())["kind"] == "eject" for r in caplog.records
                   if r.name == HEALTH_EVENTS)


# ------------------------------------------------------------- the Manager
def _manager_shell(tracer_buffer=16):
    """A Manager without its network, enough for report_error and
    timings()."""
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.tracing import SpanRecorder, TraceConfig

    m = Manager.__new__(Manager)
    m._errored = None
    m._replica_id = "drop_test:0"
    m._group_rank = 0
    m._step = 5
    m._quorum_id = 2
    m._metrics_lock = threading.Lock()
    m._metrics = {"errors": 0}
    m._timings = {}
    m._tracer = SpanRecorder("drop_test", TraceConfig(enabled=True, buffer=tracer_buffer))
    m._dropped_events_warned = False
    return m


def test_manager_emits_an_error_event_on_report_error(caplog):
    m = _manager_shell()
    with caplog.at_level(logging.INFO, logger=ERROR_EVENTS):
        m.report_error(RuntimeError("injected"))
    records = [r for r in caplog.records if r.name == ERROR_EVENTS]
    assert len(records) == 1
    payload = json.loads(records[0].getMessage())
    assert (payload["step"], payload["quorum_id"], payload["replica_id"]) == (5, 2, "drop_test:0")
    assert "injected" in payload["error"]
    assert m.errored() is not None and m._metrics["errors"] == 1


class TestObservabilityHonestyCounters:
    def test_saturated_queues_surface_and_warn_once(self, caplog, monkeypatch):
        from torchft_tpu_torch import manager as manager_mod

        m = _manager_shell(tracer_buffer=16)
        for i in range(20):
            m._tracer.instant("e", cat="rpc", i=i)
        monkeypatch.setattr(manager_mod, "get_event_drain", lambda: SimpleNamespace(dropped=3))
        with caplog.at_level(logging.WARNING, logger="torchft_tpu_torch.manager"):
            t1 = m.timings()
            t2 = m.timings()
        assert (t1["dropped_events"], t1["trace_dropped"], t2["dropped_events"]) == (3.0, 4.0, 3.0)
        warns = [r for r in caplog.records if "observability queues saturated" in r.getMessage()]
        assert len(warns) == 1
        assert "3 telemetry event(s)" in warns[0].getMessage()
        assert "4 span(s)" in warns[0].getMessage()

    def test_clean_queues_report_zero_and_stay_quiet(self, caplog, monkeypatch):
        from torchft_tpu_torch import manager as manager_mod

        m = _manager_shell()
        m._tracer.instant("e", cat="rpc")
        monkeypatch.setattr(manager_mod, "get_event_drain", lambda: SimpleNamespace(dropped=0))
        with caplog.at_level(logging.WARNING, logger="torchft_tpu_torch.manager"):
            t = m.timings()
        assert (t["dropped_events"], t["trace_dropped"]) == (0.0, 0.0)
        assert not [r for r in caplog.records if "observability queues saturated" in r.getMessage()]


# ---------------------------------------------------------------- /metrics
def _fill(reg):
    reg.gauge_set("torchft_test_gauge", 2.5, "A gauge.")
    reg.gauge_set("torchft_a_gauge", -1.0)
    reg.counter_set("torchft_test_total", 7.0, "A counter.")
    reg.counter_set("torchft_test_total", 9.0, "A counter.")
    for v in (0.005, 0.05, 0.05, 5.0, 100.0, 0.0005):
        reg.observe("torchft_test_seconds", v, "A histogram.")
    reg.observe("torchft_custom_bytes", 3.0, "", buckets=(1.0, 4.0))


class TestMetricsRegistry:
    def test_render_is_the_references_byte_for_byte(self):
        ours, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
        _fill(ours)
        _fill(ref)
        assert ours.render().encode() == ref.render().encode()
        assert MetricsRegistry().render() == ref_obs.MetricsRegistry().render()

    def test_render_is_valid_prometheus_text(self):
        reg = MetricsRegistry()
        _fill(reg)
        text = reg.render()
        for line in ("# HELP torchft_test_gauge A gauge.", "# TYPE torchft_test_gauge gauge",
                     "torchft_test_gauge 2.5", "# TYPE torchft_test_total counter",
                     "torchft_test_total 9.0", "# TYPE torchft_test_seconds histogram",
                     'torchft_test_seconds_bucket{le="+Inf"} 6', "torchft_test_seconds_count 6"):
            assert line in text.splitlines(), line
        counts = [float(l.rsplit(" ", 1)[1]) for l in text.splitlines()
                  if l.startswith("torchft_test_seconds_bucket{")]
        assert counts == sorted(counts)

    def test_server_serves_the_references_text_and_refreshes(self):
        ours, ref = MetricsRegistry(), ref_obs.MetricsRegistry()
        calls = []

        def refresh():
            calls.append(1)
            for reg in (ours, ref):
                reg.gauge_set("torchft_refresh_gauge", float(len(calls)), "Scrape-time refresh.")

        _fill(ours)
        _fill(ref)
        srv = MetricsServer(ours, port=0, refresh=refresh)
        try:
            for n in (1, 2):
                url = f"http://127.0.0.1:{srv.port}/metrics"
                with urllib.request.urlopen(url, timeout=5.0) as resp:
                    assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
                    body = resp.read()
                assert body == ref.render().encode()
                assert f"torchft_refresh_gauge {float(n)}".encode() in body
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other", timeout=5.0)
            assert e.value.code == 404
        finally:
            srv.shutdown()

    def test_a_failing_refresh_answers_500(self):
        def refresh():
            raise RuntimeError("boom")

        srv = MetricsServer(MetricsRegistry(), port=0, refresh=refresh)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=5.0)
            assert e.value.code == 500
        finally:
            srv.shutdown()
