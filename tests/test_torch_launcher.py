"""The port's supervising launcher (``torchft_tpu_torch/launcher.py``) and
punisher (``torchft_tpu_torch/examples/punisher.py``) against the
reference's.

The reference's launcher scenarios (``tests/test_launcher.py:55-87``: the
environment contract, a restarted group, a group out of restarts) run the
same worker scripts under both packages' launchers, which must agree on
the exit code and on each group's restarts. The port's workers also get
torchrun's variables, enough for a two-rank group to join gloo. The
punisher kills through the lighthouse: ``kill_one`` reaches exactly one
group's leader (the only process with a manager server), the launcher
takes the rest of that group down and restarts it; ``kill_all`` reaches
every group.
"""

import logging
import os
import sys
import textwrap
import threading
import time

import pytest
from test_launcher import WORKER_FLAKY, WORKER_OK

from torchft_tpu import launcher as ref_launcher
from torchft_tpu_torch import launcher
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.examples import punisher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"reference": ref_launcher, "port": launcher}


def _script(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    return str(p)


def _restarts(caplog, pkg) -> dict:
    """Restarts per group, from the launcher's warnings."""
    out = {}
    for rec in caplog.records:
        if rec.name == pkg.__name__ and "died" in rec.getMessage() and "restart " in \
                rec.getMessage():
            group = int(rec.getMessage().split("replica group ", 1)[1].split()[0])
            out[group] = out.get(group, 0) + 1
    return out


@pytest.mark.parametrize("scenario", ["env_contract", "restart", "out_of_restarts"])
def test_launchers_agree(tmp_path, caplog, scenario):
    caplog.set_level(logging.INFO)
    results = {}
    for name, pkg in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        if scenario == "env_contract":
            kwargs = dict(cmd=[sys.executable, _script(work, "ok.py", WORKER_OK)], num_groups=2)
        elif scenario == "restart":
            kwargs = dict(cmd=[sys.executable, _script(work, "flaky.py", WORKER_FLAKY), str(work)],
                          num_groups=2, max_restarts=1)
        else:
            kwargs = dict(cmd=[sys.executable, _script(work, "dead.py", "import sys; sys.exit(2)")],
                          num_groups=1, max_restarts=0)
        caplog.clear()
        code = pkg.launch_replica_groups(poll_interval=0.2, **kwargs)
        results[name] = (code, _restarts(caplog, pkg))
        if scenario == "restart":
            assert (work / "died_1").exists()
    assert results["port"] == results["reference"], results
    assert results["port"] == {"env_contract": (0, {}), "restart": (0, {1: 1}),
                               "out_of_restarts": (1, {})}[scenario]


GLOO_WORKER = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    assert os.environ["RANK"] == os.environ["GROUP_RANK"] == os.environ["LOCAL_RANK"]
    assert os.environ["WORLD_SIZE"] == os.environ["GROUP_WORLD_SIZE"] == "2"
    dist.init_process_group("gloo", init_method="env://")
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    rid = os.environ["REPLICA_GROUP_ID"]
    with open(os.path.join(sys.argv[1], f"sum_{rid}_{dist.get_rank()}_{os.environ['MASTER_PORT']}"),
              "w") as f:
        f.write(str(t.item()))
    dist.destroy_process_group()
    if rid == "1" and not os.path.exists(os.path.join(sys.argv[1], "again")):
        open(os.path.join(sys.argv[1], "again"), "w").close()
        sys.exit(3)  # group 1's first incarnation dies once it has met
""")


def test_torch_variables_let_a_two_rank_group_join_gloo(tmp_path, monkeypatch):
    """Each group's two workers meet in gloo on the rendezvous store the
    launcher hosts for the incarnation: group 1's restart meets on a fresh
    one."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    script = _script(tmp_path, "gloo.py", GLOO_WORKER)
    code = launcher.launch_replica_groups([sys.executable, script, str(tmp_path)], num_groups=2,
                                          workers_per_replica=2, max_restarts=1,
                                          poll_interval=0.2)
    assert code == 0
    sums = sorted(p.name for p in tmp_path.glob("sum_*"))
    assert all(p.read_text() == "3.0" for p in tmp_path.glob("sum_*"))
    ports = {g: {n.rsplit("_", 1)[1] for n in sums if n.startswith(f"sum_{g}_")} for g in "01"}
    assert len(ports["0"]) == 1 and len(ports["1"]) == 2  # a fresh store a restart
    assert len(sums) == 6


LEADER_WORKER = textwrap.dedent("""
    import os, pathlib, sys, time
    d = pathlib.Path(sys.argv[1])
    rid, rank = os.environ["REPLICA_GROUP_ID"], os.environ["GROUP_RANK"]
    inc = len(list(d.glob(f"start_{rid}_{rank}_*")))
    (d / f"start_{rid}_{rank}_{inc}").write_text(str(os.getpid()))
    if rank == "0":
        # the group leader: the only process with a manager server
        from torchft_tpu_torch.coordination import ManagerClient, ManagerServer
        srv = ManagerServer(replica_id=f"grp{rid}:{inc}",
                            lighthouse_addr=os.environ["TORCHFT_LIGHTHOUSE"],
                            hostname="127.0.0.1", bind="127.0.0.1:0", store_addr="none",
                            world_size=1)
        client = ManagerClient(srv.address())
        while not (d / "stop").exists():
            try:
                client._quorum(0, 0, "", False, 2.0)
                (d / f"joined_{rid}_{inc}").touch()
            except Exception:
                pass
            time.sleep(0.05)
    while not (d / "stop").exists():
        time.sleep(0.05)
""")


def test_punisher_kills_one_group_then_every_group(tmp_path, caplog, monkeypatch):
    """``kill_one`` reaches group 1's leader alone: it exits, the launcher
    SIGTERMs group 1's other worker and restarts the group, and group 0
    runs on untouched. ``kill_all`` then reaches both leaders and the
    launcher restarts both groups."""
    caplog.set_level(logging.INFO)
    monkeypatch.setenv("PYTHONPATH", REPO)
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100,
                          quorum_tick_ms=20, heartbeat_timeout_ms=5000)
    addr = f"127.0.0.1:{lh.port}"
    script = _script(tmp_path, "leader.py", LEADER_WORKER)
    out = {}
    t = threading.Thread(target=lambda: out.update(code=launcher.launch_replica_groups(
        [sys.executable, script, str(tmp_path)], num_groups=2, workers_per_replica=2,
        lighthouse_addr=addr, max_restarts=2, poll_interval=0.2)))
    t.start()

    def wait_for(*names, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not all((tmp_path / n).exists() for n in names):
            assert time.monotonic() < deadline, f"no {names}"
            time.sleep(0.05)

    def pid(name):
        return int((tmp_path / name).read_text())

    def alive(p):
        try:
            os.kill(p, 0)
            return True
        except ProcessLookupError:
            return False

    try:
        wait_for("joined_0_0", "joined_1_0")
        assert sorted(punisher.list_replicas(addr)) == ["grp0:0", "grp1:0"]
        first = {n: pid(n) for n in ("start_0_0_0", "start_0_1_0", "start_1_0_0", "start_1_1_0")}
        assert punisher.kill_one(addr, "grp1:0") == 0
        wait_for("joined_1_1", "start_1_1_1")
        assert not alive(first["start_1_0_0"]) and not alive(first["start_1_1_0"])
        assert alive(first["start_0_0_0"]) and alive(first["start_0_1_0"])
        assert not (tmp_path / "start_0_0_1").exists()
        wait_for("joined_0_0", "joined_1_1")
        assert punisher.kill_all(addr) == 0
        wait_for("joined_0_1", "joined_1_2", "start_0_1_1", "start_1_1_2")
        assert not alive(first["start_0_0_0"]) and not alive(first["start_0_1_0"])
    finally:
        (tmp_path / "stop").touch()
        t.join(60)
        lh.shutdown()
    assert out["code"] == 0
    assert _restarts(caplog, launcher) == {0: 1, 1: 2}
    # each kill reached the leader alone: its peer was still running
    died = [r.getMessage() for r in caplog.records if "died" in r.getMessage()]
    assert died and all("codes=[1, None]" in m for m in died), died
