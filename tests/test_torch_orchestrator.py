"""The port's orchestrator (``torchft_tpu_torch/examples/orchestrator.py``)
against the reference's (``examples/orchestrator.py``): each package's
``ReplicaActor`` supervising the same scripted fake worker under the same
``RetryPolicy`` reaches the same statuses, restart counts and lines (a
worker that fails twice then succeeds; one that never succeeds and runs
out of restarts; one deaf to SIGTERM, escalated to SIGKILL on stop). Then
one end-to-end run of the port's CLI on the CPU: two ``train_ddp`` workers,
one killed through the lighthouse, restarted, healed, both succeeded with
equal parameter digests."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time
import types

import pytest

from torchft_tpu_torch.examples import orchestrator as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_ref():
    spec = importlib.util.spec_from_file_location(
        "ref_orchestrator", os.path.join(REPO, "examples", "orchestrator.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_ref()
PACKAGES = {"reference": ref, "port": port}

# a worker that exits with the next code of its script, one per start
SCRIPTED = (
    "import pathlib, sys\n"
    "state = pathlib.Path(sys.argv[1]); codes = [int(c) for c in sys.argv[2].split(',')]\n"
    "n = int(state.read_text()) if state.exists() else 0\n"
    "state.write_text(str(n + 1))\n"
    "sys.exit(codes[min(n, len(codes) - 1)])\n"
)
# a worker that ignores SIGTERM, says so, and sleeps
DEAF = (
    "import signal, sys, time\n"
    "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "print('deaf', flush=True)\n"
    "time.sleep(600)\n"
)


def _supervise(mod, cmd, policy, timeout=60.0):
    actor = mod.ReplicaActor(0, cmd, dict(os.environ), policy)
    actor.start()
    actor.join(timeout)
    assert actor.status in ("succeeded", "failed"), actor.status
    return actor


@pytest.mark.parametrize("codes, max_restarts, want", [
    ("1,1,0", 3, ("succeeded", 2)),
    ("1", 2, ("failed", 2)),
    ("0", 0, ("succeeded", 0)),
    ("3,0", 0, ("failed", 0)),
], ids=["fails_twice_then_succeeds", "out_of_restarts", "first_try", "no_restarts_allowed"])
def test_replica_actor_same_outcome_in_both_packages(codes, max_restarts, want, tmp_path,
                                                     capfd):
    seen = {}
    for name, mod in PACKAGES.items():
        state = tmp_path / f"{name}.count"
        cmd = [sys.executable, "-c", SCRIPTED, str(state), codes]
        actor = _supervise(mod, cmd, mod.RetryPolicy(max_restarts=max_restarts, backoff_s=0.05))
        lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[actor")]
        seen[name] = (actor.status, actor.restarts, int(state.read_text()), lines)
    assert seen["port"] == seen["reference"]
    status, restarts, starts, lines = seen["port"]
    assert (status, restarts) == want and starts == restarts + 1
    rcs = codes.split(",")
    died = [f"[actor 0] worker died rc={rcs[min(i, len(rcs) - 1)]}; "
            f"restart {i + 1}/{max_restarts}" for i in range(restarts)]
    assert lines == died + (["[actor 0] out of restarts"] if status == "failed" else [])


class _Popen(subprocess.Popen):
    """Popen whose waits with a deadline wait at most 0.5 s: the actors' 30 s
    grace for a SIGTERM, cut for the test; the escalation path is theirs."""

    def wait(self, timeout=None):
        return super().wait(None if timeout is None else min(timeout, 0.5))


def test_sigterm_deaf_worker_is_killed_and_stopped_in_both_packages(monkeypatch, capfd):
    shim = types.SimpleNamespace(Popen=_Popen, TimeoutExpired=subprocess.TimeoutExpired)
    outcome = {}
    for name, mod in PACKAGES.items():
        monkeypatch.setattr(mod, "subprocess", shim)
        actor = mod.ReplicaActor(0, [sys.executable, "-c", DEAF], dict(os.environ),
                                 mod.RetryPolicy(max_restarts=3, backoff_s=0.05))
        actor.start()
        deadline = time.monotonic() + 60
        while "deaf" not in capfd.readouterr().out and time.monotonic() < deadline:
            time.sleep(0.05)
        t0 = time.monotonic()
        actor.stop()
        actor.join(30)
        outcome[name] = (actor.status, actor.restarts, actor._thread.is_alive())
        assert time.monotonic() - t0 < 10, name
    assert outcome["port"] == outcome["reference"] == ("stopped", 0, False)


def test_cli_end_to_end_on_the_cpu():
    """Two train_ddp workers on the CPU; the failure controller kills one
    through the lighthouse (the last of the members it lists: the second
    worker once both are in the quorum), its actor restarts it, it heals
    from the survivor, and both succeed with equal digests. The kill's
    seconds only place it after the workers' start; the gates read the
    transcript's evidence (the steps must outlast the restart, since the
    survivor trains on alone meanwhile)."""
    steps = 1000
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.examples.orchestrator", "--replicas", "2",
         "--steps", str(steps), "--inject-kill-after", "8", "--device", "cpu"],
        cwd=REPO, env={k: v for k, v in os.environ.items() if not k.startswith("TORCHFT_")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError("orchestrator wedged past 240 s:\n" + out[-4000:]) from None
    lines = out.splitlines()
    tail = "\n".join(ln for ln in lines if "] step=" not in ln and "[lighthouse]" not in ln
                     and "[manager" not in ln)[-4000:]
    assert proc.returncode == 0, tail
    killed = [(i, m) for i, ln in enumerate(lines)
              for m in re.finditer(r"^\[chaos\] killed train_ddp_(\d):", ln)]
    assert len(killed) == 1, tail
    k, victim = killed[0][0], int(killed[0][1].group(1))
    assert any(ln.startswith(f"[actor {victim}] worker died rc=") and "restart 1/3" in ln
               for ln in lines[k:]), tail
    assert f"  replica {1 - victim}: succeeded after 0 restart(s)" in lines, tail
    assert f"  replica {victim}: succeeded after 1 restart(s)" in lines, tail
    # the workers share the orchestrator's stdout: a long done: line can be
    # written in pieces, so another worker's line may start inside it
    done = {}
    for ln in lines:
        for m in re.finditer(r"\[replica (\d)\] done: ", ln):
            done[int(m.group(1))] = json.JSONDecoder().raw_decode(ln, m.end())[0]
    assert sorted(done) == [0, 1] and all(d["step"] == steps for d in done.values()), tail
    assert done[victim]["metrics"]["heals"] >= 1, done[victim]["metrics"]
    assert done[0]["params_sha256"] == done[1]["params_sha256"]
