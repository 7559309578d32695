"""Actor-style orchestration of a fault-tolerant job: the port's counterpart
of ``examples/orchestrator.py`` (reference: torchft's
examples/monarch/train_distributed.py:27-442 — LighthouseActor,
TrainingActor/ReplicaActor, OrchestrationManager, FailureController).

Plain threads play the actor roles:

- ``LighthouseActor``  — owns the in-process lighthouse server
  (``torchft_tpu_torch.coordination.LighthouseServer``)
- ``ReplicaActor``     — supervises one replica group's worker subprocess;
  restarts it per the retry policy and reports state transitions (a stop
  sends SIGTERM, then SIGKILL after 30 s)
- ``FailureController``— injects failures (kill via the lighthouse HTTP
  endpoint) on a schedule to prove recovery
- ``OrchestrationManager`` — wires the actors, waits for completion, and
  reports a summary (restarts per replica, final status)

Each worker is ``python -m torchft_tpu_torch.examples.train_ddp --steps N
--device D``, run from the directory that holds the package, on the card
unless ``--device cpu``. The environment passes through, so
``TORCHFT_COMPRESS=fp8`` around the orchestrator codes every worker's
streamed gradient buckets in fp8 (on the card: the host-rule quantize and
the dequantize kernels).

Demo (2 replica groups, one injected kill):

    python -m torchft_tpu_torch.examples.orchestrator --replicas 2 --steps 400 \\
        --inject-kill-after 12 --device cpu
    TORCHFT_COMPRESS=fp8 python -m torchft_tpu_torch.examples.orchestrator \\
        --replicas 2 --steps 2000 --inject-kill-after 20   # on the card

It prints ``[orchestrator] summary:`` and a ``replica i: <status> after N
restart(s)`` line a replica group, and exits 0 only when every group
succeeded.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import List, Optional

from torchft_tpu_torch.coordination import LighthouseServer

__all__ = ["FailureController", "LighthouseActor", "OrchestrationManager", "ReplicaActor",
           "RetryPolicy", "main"]

# the directory holding the package: workers run from it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class LighthouseActor:
    def __init__(self, min_replicas: int) -> None:
        self.server = LighthouseServer(
            bind="127.0.0.1:0", min_replicas=min_replicas, join_timeout_ms=500,
            quorum_tick_ms=50, heartbeat_timeout_ms=2000,
        )
        self.addr = f"127.0.0.1:{self.server.port}"

    def stop(self) -> None:
        self.server.shutdown()


@dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 1.0


class ReplicaActor:
    """Supervises one replica group's worker process (reference
    ReplicaActor + its restart loop). ``cwd`` is the worker's directory
    (None: this process's)."""

    def __init__(self, rid: int, cmd: list, env: dict, policy: RetryPolicy,
                 cwd: Optional[str] = None) -> None:
        self.rid = rid
        self.cmd = cmd
        self.env = env
        self.policy = policy
        self.cwd = cwd
        self.restarts = 0
        self.status = "pending"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"replica_actor_{rid}")

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.status = "running"
            proc = subprocess.Popen(self.cmd, env=self.env, cwd=self.cwd)
            while proc.poll() is None:
                if self._stop.wait(0.5):
                    proc.terminate()
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        # SIGTERM-deaf worker: escalate so the actor thread
                        # reaches a terminal status and no orphan survives
                        proc.kill()
                        proc.wait()
                    self.status = "stopped"
                    return
            if proc.returncode == 0:
                self.status = "succeeded"
                return
            if self.restarts >= self.policy.max_restarts:
                self.status = "failed"
                print(f"[actor {self.rid}] out of restarts", flush=True)
                return
            self.restarts += 1
            self.status = "restarting"
            print(f"[actor {self.rid}] worker died rc={proc.returncode}; "
                  f"restart {self.restarts}/{self.policy.max_restarts}", flush=True)
            time.sleep(self.policy.backoff_s)

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)


class FailureController:
    """Injects failures through the lighthouse kill endpoint
    (reference FailureController)."""

    def __init__(self, lighthouse_addr: str, after_s: float) -> None:
        self._addr = lighthouse_addr
        self._after = after_s
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.killed: list = []

    def start(self) -> None:
        self._thread.start()

    def _members(self) -> list:
        # one copy of the /status parsing: punisher.list_replicas handles
        # both participant shapes (bare ids vs member objects)
        from torchft_tpu_torch.examples.punisher import list_replicas

        members = list_replicas(self._addr)
        return sorted(set(members))

    def _run(self) -> None:
        time.sleep(self._after)
        try:
            members = []
            for _ in range(60):  # replicas may still be starting up
                members = self._members()
                if members:
                    break
                time.sleep(1)
            if not members:
                print("[chaos] no participants to kill", flush=True)
                return
            victim = members[-1]
            req = urllib.request.Request(
                f"http://{self._addr}/replica/{victim}/kill", method="POST"
            )
            with urllib.request.urlopen(req, timeout=10):
                pass
            self.killed.append(victim)
            print(f"[chaos] killed {victim}", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"[chaos] injection failed: {e}", flush=True)


@dataclass
class OrchestrationManager:
    """Wires the actors and owns the job lifecycle (reference
    OrchestrationManager). ``device`` is the workers' (None: the card)."""

    replicas: int
    steps: int
    policy: RetryPolicy = field(default_factory=RetryPolicy)
    inject_kill_after: float = 0.0
    device: Optional[str] = None

    def run(self) -> int:
        lighthouse = LighthouseActor(min_replicas=1)
        print(f"[orchestrator] lighthouse at http://{lighthouse.addr}/", flush=True)

        actors = [
            ReplicaActor(
                rid,
                [sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp",
                 "--steps", str(self.steps), "--device", self.device or "cuda"],
                dict(os.environ, TORCHFT_LIGHTHOUSE=lighthouse.addr,
                     REPLICA_GROUP_ID=str(rid)),
                self.policy,
                cwd=_ROOT,
            )
            for rid in range(self.replicas)
        ]
        chaos = None
        if self.inject_kill_after > 0:
            chaos = FailureController(lighthouse.addr, self.inject_kill_after)

        for a in actors:
            a.start()
        if chaos:
            chaos.start()

        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            if all(a.status in ("succeeded", "failed", "stopped") for a in actors):
                break
            time.sleep(1)
        for a in actors:
            a.stop()
            a.join(timeout=30)
        lighthouse.stop()

        print("[orchestrator] summary:", flush=True)
        rc = 0
        for a in actors:
            print(f"  replica {a.rid}: {a.status} after {a.restarts} restart(s)",
                  flush=True)
            rc |= 0 if a.status == "succeeded" else 1
        if chaos and not chaos.killed:
            print("  (chaos injection did not fire)", flush=True)
        return rc


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--inject-kill-after", type=float, default=0.0)
    parser.add_argument("--device", default=None, help="the workers' device (default: cuda)")
    args = parser.parse_args(argv)
    rc = OrchestrationManager(
        replicas=args.replicas,
        steps=args.steps,
        policy=RetryPolicy(max_restarts=args.max_restarts),
        inject_kill_after=args.inject_kill_after,
        device=args.device,
    ).run()
    sys.exit(rc)


if __name__ == "__main__":
    main()
