"""The two-level control plane on the port: ``AggregatorServer``,
``ManagerServer(aggregator_addr=)`` / ``control_status()``, the Manager's
``TORCHFT_LIGHTHOUSE_AGGREGATOR`` with ``via_aggregator`` /
``aggregator_failovers`` in ``timings()`` and on ``/metrics``, the
aggregator's CLI and its check, against the reference's.

The aggregator scenarios of ``tests/test_fleet.py`` (``:95``, ``:219``,
``:272``, ``:310-330``) run on both packages' bindings of the same native
servers, each observation equal; then one aggregator-crash script drives a
Manager of each package.
"""

import os
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from torchft_tpu import coordination as ref_coord
from torchft_tpu import manager as ref_manager
from torchft_tpu import process_group as ref_pg
from torchft_tpu.doctor import check_aggregator as ref_check_aggregator
from torchft_tpu.retry import RetryPolicy as RefRetryPolicy
from torchft_tpu_torch import coordination as port_coord
from torchft_tpu_torch import manager as port_manager
from torchft_tpu_torch import process_group as port_pg
from torchft_tpu_torch.aggregator import check_aggregator
from torchft_tpu_torch.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEALTH_OFF = {"mode": "off"}
PACKAGES = {
    "reference": (ref_coord, RefRetryPolicy(max_attempts=1), ref_manager, ref_pg),
    "port": (port_coord, RetryPolicy(max_attempts=1), port_manager, port_pg),
}


def _wait_for(pred, timeout=10.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise TimeoutError(f"timed out waiting for {msg}")


def _on_both(scenario):
    """``scenario(coord, no_retry)`` on the reference's bindings, then the
    port's: equal observations."""
    got = {name: scenario(coord, no_retry) for name, (coord, no_retry, _, _) in PACKAGES.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


def _member(rid: str, address: str, store: str, step: int) -> dict:
    return {"replica_id": rid, "address": address, "store_address": store, "step": step,
            "world_size": 1, "shrink_only": False, "commit_failures": 0, "data": ""}


def test_beats_and_quorum_flow_through_aggregator():
    """Two pod replicas talk only to the aggregator: their beats surface at
    the root as ``agg_tick`` traffic, and a quorum round resolves through
    the tier with the members intact."""
    def scenario(coord, no_retry):
        root = coord.LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                                      quorum_tick_ms=20, health=HEALTH_OFF)
        root_addr = f"127.0.0.1:{root.port}"
        agg = coord.AggregatorServer(root_addr=root_addr, bind="127.0.0.1:0", agg_id="podA",
                                     tick_ms=50)
        agg_addr = f"127.0.0.1:{agg.port}"
        try:
            c1 = coord._RawClient(agg_addr, retry_policy=no_retry)
            c2 = coord._RawClient(agg_addr, retry_policy=no_retry)
            root_c = coord._RawClient(root_addr, retry_policy=no_retry)
            beat = c1.call("heartbeat", {"replica_id": "rep_a",
                                         "telemetry": {"step": 1, "step_s": 0.5}}, 5.0)
            c2.call("heartbeat", {"replica_id": "rep_b"}, 5.0)
            _wait_for(lambda: {"rep_a", "rep_b"}.issubset(
                root_c.call("status", {}, 5.0)["heartbeat_ages_ms"]), msg="beats at the root")
            st = root_c.call("status", {}, 5.0)
            with ThreadPoolExecutor(max_workers=2) as ex:
                f1 = ex.submit(c1.call, "quorum",
                               {"requester": _member("rep_a", "a:1", "s:1", 3)}, 10.0)
                f2 = ex.submit(c2.call, "quorum",
                               {"requester": _member("rep_b", "b:1", "s:2", 3)}, 10.0)
                q1, q2 = f1.result()["quorum"], f2.result()["quorum"]
            byid = {m["replica_id"]: m for m in q2["participants"]}
            return {
                "aggregated": bool(beat.get("aggregated")),
                "pod_live": st["aggregators"]["podA"]["live"],
                "agg_ticks": st["rx"].get("agg_tick", {}).get("calls", 0) > 0,
                "direct_beats": st["rx"].get("heartbeat", {}).get("calls", 0),
                "same_quorum": q1["quorum_id"] == q2["quorum_id"],
                "members": sorted(byid),
                "rep_a": (byid["rep_a"]["address"], byid["rep_a"]["step"]),
                "pod_size": agg.status()["pod_size"],
            }
        finally:
            agg.shutdown()
            root.shutdown()

    got = _on_both(scenario)
    assert got["pod_live"] == 2 and got["agg_ticks"] and got["direct_beats"] == 0
    assert got["same_quorum"] and got["members"] == ["rep_a", "rep_b"]
    assert got["rep_a"] == ("a:1", 3)


def test_crash_mid_tick_falls_back_without_losing_quorum_round():
    """The aggregator dies under its pod: both manager servers resolve the
    next quorum round straight at the root, within that one call, and their
    control status shows the failover."""
    def scenario(coord, no_retry):
        root = coord.LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                                      quorum_tick_ms=20, health=HEALTH_OFF)
        root_addr = f"127.0.0.1:{root.port}"
        agg = coord.AggregatorServer(root_addr=root_addr, bind="127.0.0.1:0", agg_id="podF",
                                     tick_ms=50)
        agg_addr = f"127.0.0.1:{agg.port}"
        mgrs = [coord.ManagerServer(replica_id=f"rep_{x}", lighthouse_addr=root_addr,
                                    hostname="127.0.0.1", bind="127.0.0.1:0",
                                    store_addr=f"s{x}", world_size=1, aggregator_addr=agg_addr)
                for x in "ab"]
        try:
            root_c = coord._RawClient(root_addr, retry_policy=no_retry)
            _wait_for(lambda: {"rep_a", "rep_b"}.issubset(
                root_c.call("status", {}, 5.0)["heartbeat_ages_ms"]), msg="beats via the pod")
            before = mgrs[0].control_status()
            agg.shutdown()
            clients = [coord.ManagerClient(f"127.0.0.1:{m.port}") for m in mgrs]
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(c._quorum, 0, 0, f"meta_{i}", False, 20.0)
                        for i, c in enumerate(clients)]
                ra, rb = (f.result() for f in futs)
            after = mgrs[0].control_status()
            return {
                "before": (before["aggregator_addr"] == agg_addr, before["via_aggregator"],
                           before["failovers"]),
                "same_quorum": ra.quorum_id == rb.quorum_id,
                "world": ra.replica_world_size,
                "failed_over": bool(after["direct_mode"] or after["failovers"] >= 1),
            }
        finally:
            for m in mgrs:
                m.shutdown()
            agg.shutdown()
            root.shutdown()

    got = _on_both(scenario)
    assert got == {"before": (True, True, 0), "same_quorum": True, "world": 2,
                   "failed_over": True}


def test_root_names_replacement_aggregator():
    """A direct beat asking ``want_aggregator`` gets the live aggregator
    back (how a failed-over manager re-points); a flat beat does not."""
    def scenario(coord, no_retry):
        root = coord.LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
        root_addr = f"127.0.0.1:{root.port}"
        agg = coord.AggregatorServer(root_addr=root_addr, bind="127.0.0.1:0", agg_id="podR",
                                     tick_ms=50)
        try:
            c = coord._RawClient(root_addr, retry_policy=no_retry)
            _wait_for(lambda: "podR" in c.call("status", {}, 5.0)["aggregators"],
                      msg="the aggregator at the root")
            named = c.call("heartbeat", {"replica_id": "rep_solo", "want_aggregator": True},
                           timeout=5.0, retry=False)
            flat = c.call("heartbeat", {"replica_id": "rep_solo"}, timeout=5.0, retry=False)
            return (named.get("aggregator", "").endswith(str(agg.port)), "aggregator" in flat)
        finally:
            agg.shutdown()
            root.shutdown()

    assert _on_both(scenario) == (True, False)


@pytest.mark.parametrize("env, ok, phrase", [
    pytest.param({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "no-port-here"}, False, "host:port",
                 id="malformed_addr"),
    pytest.param({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "10.0.0.1:29520"}, False, "fail over",
                 id="aggregator_without_root"),
    pytest.param({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "10.0.0.1:29520",
                  "TORCHFT_LIGHTHOUSE": "10.0.0.2:29510"}, True, "two-level",
                 id="well_formed_two_level"),
])
def test_check_aggregator_agrees_with_the_reference_doctor(monkeypatch, env, ok, phrase):
    """The reference doctor's aggregator check (``tests/test_fleet.py:310-330``)
    and the port's: the environment's wiring, then a loopback beat that
    reaches a root through ``agg_tick``."""
    monkeypatch.delenv("TORCHFT_LIGHTHOUSE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (ref_ok, ref_detail), (port_ok, port_detail) = ref_check_aggregator(), check_aggregator()
    assert ref_ok is port_ok is ok
    assert phrase in ref_detail and phrase in port_detail
    if ok:
        assert "agg_tick" in ref_detail and "agg_tick" in port_detail


def test_manager_reports_the_aggregator_as_the_reference(monkeypatch):
    """One Manager a package under ``TORCHFT_LIGHTHOUSE_AGGREGATOR``, the
    same script: two steps through the aggregator, its death, two more
    steps. ``timings()`` carries ``via_aggregator`` / ``aggregator_failovers``
    alike (the root forgets the dead aggregator before the third step, so
    nothing re-points to it), every step commits, and the port's
    ``/metrics`` shows them."""
    def script(coord, manager_mod, pg_mod):
        root = coord.LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                                      quorum_tick_ms=20, heartbeat_timeout_ms=500,
                                      health=HEALTH_OFF)
        root_addr = f"127.0.0.1:{root.port}"
        agg = coord.AggregatorServer(root_addr=root_addr, bind="127.0.0.1:0", agg_id="podM",
                                     tick_ms=50, heartbeat_timeout_ms=500)
        root_c = coord._RawClient(root_addr, retry_policy=PACKAGES["port"][1])
        monkeypatch.setenv(manager_mod.AGGREGATOR_ENV, f"127.0.0.1:{agg.port}")
        kwargs = {"metrics_port": 0} if manager_mod is port_manager else {}
        m = manager_mod.Manager(pg=pg_mod.ProcessGroupDummy(), load_state_dict=lambda sd: None,
                                state_dict=lambda: {}, min_replica_size=1,
                                replica_id="agg_script", lighthouse_addr=root_addr, timeout=10.0,
                                **kwargs)
        seen, metrics = [], ""
        try:
            for step in range(4):
                if step == 2:
                    agg.shutdown()
                    # once the root no longer counts it live it names no
                    # aggregator to re-point to
                    _wait_for(lambda: root_c.call("status", {}, 5.0)["aggregators"]["podM"]
                              ["age_ms"] > 600, msg="the root to forget the aggregator")
                m.start_quorum()
                m.wait_quorum()
                assert m.should_commit()
                t = m.timings()
                seen.append((t["via_aggregator"], t["aggregator_failovers"] >= 1))
                if step == 1 and "metrics_port" in kwargs:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{m.metrics_port}/metrics", timeout=5.0) as r:
                        metrics = r.read().decode()
            return seen, m.current_step(), metrics
        finally:
            m.shutdown(wait=False)
            agg.shutdown()
            root.shutdown()

    ref_seen, ref_step, _ = script(ref_coord, ref_manager, ref_pg)
    port_seen, port_step, metrics = script(port_coord, port_manager, port_pg)
    assert port_seen == ref_seen == [(1.0, False), (1.0, False), (0.0, True), (0.0, True)]
    assert port_step == ref_step == 4
    assert "torchft_manager_via_aggregator 1" in metrics
    assert "torchft_manager_aggregator_failovers 0" in metrics


@pytest.mark.parametrize("module", ["torchft_tpu.aggregator", "torchft_tpu_torch.aggregator"])
def test_cli_serves_and_exits_zero_on_sigterm(module):
    """Both CLIs log their address, serve the pod's beats to the root, and
    exit 0 on SIGTERM."""
    root = port_coord.LighthouseServer(bind="127.0.0.1:0", min_replicas=1, health=HEALTH_OFF)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", module, "--root", f"127.0.0.1:{root.port}",
                             "--bind", "127.0.0.1:0", "--agg-id", "podC", "--tick-ms", "50"],
                            cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        addr = None
        for _ in range(200):
            line = proc.stderr.readline()
            if "aggregator listening at " in line:
                addr = line.split("aggregator listening at ", 1)[1].split()[0]
                break
        assert addr, "the aggregator did not log its address"
        port = addr.rsplit(":", 1)[1]
        client = port_coord.LighthouseClient(f"127.0.0.1:{port}")
        assert client.heartbeat("rep_cli").get("aggregated")
        root_c = port_coord.LighthouseClient(f"127.0.0.1:{root.port}")
        _wait_for(lambda: "rep_cli" in root_c.status()["heartbeat_ages_ms"],
                  msg="the beat at the root")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        root.shutdown()
