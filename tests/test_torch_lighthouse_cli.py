"""The port's lighthouse CLI, ``python -m torchft_tpu_torch.lighthouse``.

It is started as a subprocess on ``127.0.0.1:0``; the address it logs is
read back; two port Managers (replica threads) take a quorum through it and
commit a step; then SIGTERM (or SIGINT) stops it with exit code 0. Each
flag takes the reference CLI's underscore spelling too, and the flags map
onto the same options as the reference's.
"""

import os
import signal
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import ProcessGroupHost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
    )
    lines, found = [], threading.Event()
    addr = []

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "lighthouse listening at " in line and not addr:
                addr.append(line.split("lighthouse listening at ", 1)[1].strip())
                found.set()

    threading.Thread(target=pump, daemon=True).start()
    if not found.wait(60):
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError("no address logged:\n" + "\n".join(lines))
    return proc, addr[0], lines


def _stop(proc, sig, lines):
    proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError("the lighthouse did not stop:\n" + "\n".join(lines))
    return rc


def _quorum_of_two(addr):
    def replica(rid):
        manager = Manager(
            pg=ProcessGroupHost(timeout=20), load_state_dict=lambda sd: None,
            state_dict=lambda: {}, min_replica_size=2, replica_id=f"cli{rid}",
            lighthouse_addr=addr, timeout=20, quorum_timeout=20, init_sync=False,
        )
        try:
            manager.start_quorum()
            avg = manager.allreduce({"g": torch.full((3,), float(rid))}).get_future().wait(20)
            return manager.num_participants(), avg["g"].numpy(), manager.should_commit()
        finally:
            manager.shutdown(wait=False)

    with ThreadPoolExecutor(2) as ex:
        return [f.result(timeout=90) for f in [ex.submit(replica, r) for r in range(2)]]


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
@pytest.mark.parametrize("spelling", ["-", "_"], ids=["dashes", "underscores"])
def test_cli_serves_a_quorum_of_two_managers_and_stops_cleanly(sig, spelling):
    flag = lambda name: "--" + name.replace("-", spelling)  # noqa: E731
    proc, addr, lines = _start([
        "--bind", "127.0.0.1:0", flag("min-replicas"), "2", flag("join-timeout-ms"), "5000",
        flag("quorum-tick-ms"), "20", flag("heartbeat-timeout-ms"), "5000",
    ])
    try:
        host, _, port = addr.rpartition(":")
        assert host and int(port) > 0
        out = _quorum_of_two(addr)
        for participants, avg, committed in out:
            assert participants == 2 and committed
            np.testing.assert_array_equal(avg, np.full(3, 0.5, np.float32))
    finally:
        rc = _stop(proc, sig, lines)
    assert rc == 0, "\n".join(lines)


def _parsed(module, argv):
    """The options ``module.main(argv)`` hands its LighthouseServer."""
    seen = {}

    class _Stop(Exception):
        pass

    class _Server:
        def __init__(self, **kw):
            seen.update(kw)
            raise _Stop

    orig = module.LighthouseServer
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    module.LighthouseServer = _Server
    try:
        with pytest.raises(_Stop):
            module.main(argv)
    finally:
        module.LighthouseServer = orig
        for s, h in handlers.items():
            signal.signal(s, h)
    return seen


@pytest.mark.parametrize("argv", [[], ["--min_replicas", "3", "--quorum-tick-ms", "7"],
                                  ["--bind", "127.0.0.1:0", "--join_timeout_ms", "9",
                                   "--heartbeat-timeout-ms", "11"],
                                  ["--redundancy-directory"], ["--redundancy_directory"],
                                  ["--history", "history.jsonl"], ["--serve-registry"],
                                  ["--serve_registry", "--serve_drain_on", "eject"],
                                  ["--serve-registry", "--serve-drain-on", "warn"],
                                  ["--policy", "builtin"], ["--policy", "spec.json"]])
def test_cli_options_are_the_references(argv):
    """Defaults and spellings: the port's CLI hands its server what the
    reference's hands its own, for every option the port takes."""
    from torchft_tpu import lighthouse as jax_lighthouse
    from torchft_tpu_torch import lighthouse

    port = _parsed(lighthouse, argv)
    ref = _parsed(jax_lighthouse, argv)
    assert port == {k: ref[k] for k in port}
    assert sorted(port) == ["bind", "heartbeat_timeout_ms", "history_path", "join_timeout_ms",
                            "min_replicas", "policy", "quorum_tick_ms", "redundancy_directory",
                            "serve_drain_on", "serve_registry"]


def test_cli_exits_nonzero_on_an_unknown_flag():
    out = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.lighthouse",
                          "--no-such-flag", "x"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "unrecognized arguments" in out.stderr


def test_cli_co_hosts_the_shard_directory():
    """``--redundancy-directory``: the CLI logs the directory's URL, which
    answers its status, and stops cleanly."""
    import json
    import time
    import urllib.request

    proc, _addr, lines = _start(["--bind", "127.0.0.1:0", "--redundancy-directory"])
    try:
        deadline = time.monotonic() + 30
        url = None
        while url is None and time.monotonic() < deadline:
            url = next((ln.split("shard directory serving at ", 1)[1].split()[0]
                        for ln in list(lines) if "shard directory serving at " in ln), None)
            time.sleep(0.02)
        assert url is not None, "\n".join(lines)
        with urllib.request.urlopen(f"{url}/redundancy/status", timeout=10) as r:
            status = json.loads(r.read().decode())
        assert status["entries"] == {} and status["peers"] == []
    finally:
        rc = _stop(proc, signal.SIGTERM, lines)
    assert rc == 0, "\n".join(lines)


def test_cli_co_hosts_the_snapshot_registry(monkeypatch):
    """``--serve-registry --serve-drain-on eject``: the CLI logs the
    registry's URL, which answers its status with that drain policy, and
    stops cleanly; a bad ``--serve-drain-on`` is refused."""
    import json
    import time
    import urllib.request

    proc, _addr, lines = _start(["--bind", "127.0.0.1:0", "--serve-registry",
                                 "--serve-drain-on", "eject"])
    try:
        deadline = time.monotonic() + 30
        url = None
        while url is None and time.monotonic() < deadline:
            url = next((ln.split("snapshot registry serving at ", 1)[1].split()[0]
                        for ln in list(lines) if "snapshot registry serving at " in ln), None)
            time.sleep(0.02)
        assert url is not None, "\n".join(lines)
        with urllib.request.urlopen(f"{url}/serve/status", timeout=10) as r:
            status = json.loads(r.read().decode())
        assert status["drain_on"] == "eject" and status["sources"] == {}
    finally:
        rc = _stop(proc, signal.SIGTERM, lines)
    assert rc == 0, "\n".join(lines)
    out = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.lighthouse",
                          "--serve-registry", "--serve-drain-on", "never"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "invalid choice" in out.stderr


def test_lighthouse_server_drains_from_its_own_health(monkeypatch):
    """``LighthouseServer(serve_registry=True)``: the co-hosted registry
    reads ``TORCHFT_SERVE_DRAIN_ON`` when not told, polls this lighthouse's
    ``/health`` and is shut down with it."""
    from torchft_tpu_torch.coordination import LighthouseServer

    monkeypatch.setenv("TORCHFT_SERVE_DRAIN_ON", "eject")
    lh = LighthouseServer(bind="127.0.0.1:0", serve_registry=True)
    try:
        reg = lh.serve_registry
        assert lh.serve_registry_url() == reg.url
        assert reg.status()["drain_on"] == "eject"
        assert reg._lighthouse_addr == lh.address() and reg._poll_thread.is_alive()
    finally:
        lh.shutdown()
    assert lh.serve_registry is None and not reg._poll_thread.is_alive()
    plain = LighthouseServer(bind="127.0.0.1:0")
    try:
        assert plain.serve_registry_url() is None
    finally:
        plain.shutdown()


def test_cli_records_its_history(tmp_path):
    """``--history PATH``: the quorum the two Managers took is in the
    JSONL, and ``python -m torchft_tpu_torch.trace history`` folds it."""
    import json

    path = tmp_path / "history.jsonl"
    proc, addr, lines = _start(["--bind", "127.0.0.1:0", "--min-replicas", "2",
                                "--quorum-tick-ms", "20", "--history", str(path)])
    try:
        assert all(committed for _, _, committed in _quorum_of_two(addr))
    finally:
        rc = _stop(proc, signal.SIGTERM, lines)
    assert rc == 0, "\n".join(lines)
    out = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.trace", "history", str(path)],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["quorum_transitions"] >= 1 and len(summary["replicas"]) == 2, summary
