"""The supervising launcher of replica groups: the port's counterpart of
``torchft_tpu/launcher.py``.

It starts ``--replica-groups`` groups of ``--workers-per-replica`` worker
processes with the reference's environment contract
(``TORCHFT_LIGHTHOUSE``, ``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``,
``GROUP_RANK``, ``GROUP_WORLD_SIZE``) and supervises them: a group whose
worker exits non-zero loses its other workers (SIGTERM, then SIGKILL 30 s
later) and is started again, up to ``--max-restarts``
times, so it rejoins the quorum and heals from a peer (or restores its
durable checkpoint). A port group is a ``torch.distributed`` group, so each
worker also gets torchrun's variables: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, the port of a
rendezvous store the launcher hosts afresh for each incarnation of the
group (torchrun's agent store: ``TORCHELASTIC_USE_AGENT_STORE``), so no key
of a dead incarnation survives. Without ``--lighthouse`` it runs a
lighthouse of its own, in process. The exit code is 0 only when every
group ended cleanly.

    python -m torchft_tpu_torch.launcher --replica-groups 2 --max-restarts 3 \\
        -m torchft_tpu_torch.examples.train_llama_hsdp -- --device cpu --config debug

or ``launch_replica_groups(cmd, num_groups, ...)``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from torchft_tpu_torch.coordination import LighthouseServer

logger = logging.getLogger(__name__)

__all__ = ["ReplicaGroupSpec", "launch_replica_groups", "main"]

LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"
REPLICA_GROUP_ID_ENV = "REPLICA_GROUP_ID"
NUM_REPLICA_GROUPS_ENV = "NUM_REPLICA_GROUPS"
GROUP_RANK_ENV = "GROUP_RANK"
GROUP_WORLD_SIZE_ENV = "GROUP_WORLD_SIZE"
# SIGTERM to SIGKILL, and SIGKILL to giving up on a worker, in seconds
_KILL_TIMEOUT_S = 30.0


@dataclass
class ReplicaGroupSpec:
    """One replica group's processes (reference ``launcher.py:47-71``)."""

    cmd: List[str]
    replica_group_id: int
    num_replica_groups: int
    workers_per_replica: int = 1
    env: Dict[str, str] = field(default_factory=dict)
    # the rendezvous store of the running incarnation
    _store: Any = field(default=None, repr=False)

    def spawn(self, lighthouse_addr: str) -> List[subprocess.Popen]:
        """Start a new incarnation of the group: its workers, on a fresh
        rendezvous store."""
        from torch.distributed import TCPStore

        self._store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
        procs = []
        for group_rank in range(self.workers_per_replica):
            env = {
                **os.environ,
                **self.env,
                LIGHTHOUSE_ENV: lighthouse_addr,
                REPLICA_GROUP_ID_ENV: str(self.replica_group_id),
                NUM_REPLICA_GROUPS_ENV: str(self.num_replica_groups),
                GROUP_RANK_ENV: str(group_rank),
                GROUP_WORLD_SIZE_ENV: str(self.workers_per_replica),
                "RANK": str(group_rank),
                "WORLD_SIZE": str(self.workers_per_replica),
                "LOCAL_RANK": str(group_rank),
                "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(self._store.port),
                "TORCHELASTIC_USE_AGENT_STORE": "True",
            }
            procs.append(subprocess.Popen(self.cmd, env=env))
        return procs


def _reap(procs: List[subprocess.Popen]) -> None:
    """SIGTERM whatever still runs, SIGKILL what outlives ``_KILL_TIMEOUT_S``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=_KILL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            # a worker that traps SIGTERM must not stall the supervisor
            p.kill()
            try:
                p.wait(timeout=_KILL_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                # even SIGKILL can stall on uninterruptible I/O
                logger.warning("worker pid %s unkillable; continuing", p.pid)


def launch_replica_groups(
    cmd: List[str],
    num_groups: int,
    workers_per_replica: int = 1,
    lighthouse_addr: Optional[str] = None,
    min_replicas: Optional[int] = None,
    max_restarts: int = 0,
    poll_interval: float = 1.0,
) -> int:
    """Run ``cmd`` as ``num_groups`` replica groups, restarting a group that
    died up to ``max_restarts`` times. Returns 0 iff every group ended
    cleanly. Starts a lighthouse in process when ``lighthouse_addr`` is
    None."""
    own_lighthouse = None
    if lighthouse_addr is None:
        own_lighthouse = LighthouseServer(
            bind="0.0.0.0:0",
            min_replicas=min_replicas if min_replicas is not None else num_groups,
        )
        lighthouse_addr = own_lighthouse.address()
        logger.info("launcher lighthouse at %s", lighthouse_addr)

    specs = [ReplicaGroupSpec(cmd=cmd, replica_group_id=i, num_replica_groups=num_groups,
                              workers_per_replica=workers_per_replica)
             for i in range(num_groups)]
    groups: List[List[subprocess.Popen]] = [s.spawn(lighthouse_addr) for s in specs]
    restarts = [0] * num_groups
    done = [False] * num_groups
    failed = False

    stop = threading.Event()
    prev_handlers = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            prev_handlers[sig] = signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not on the main thread (tests)
            pass

    try:
        while not stop.is_set() and not all(done):
            time.sleep(poll_interval)
            for i, procs in enumerate(groups):
                if done[i]:
                    continue
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    done[i] = True
                    logger.info("replica group %d finished", i)
                elif any(c is not None and c != 0 for c in codes):
                    # the group's other workers would wait on the dead one
                    _reap(procs)
                    if restarts[i] < max_restarts:
                        restarts[i] += 1
                        logger.warning("replica group %d died (codes=%s); restart %d/%d",
                                       i, codes, restarts[i], max_restarts)
                        groups[i] = specs[i].spawn(lighthouse_addr)
                    else:
                        logger.error("replica group %d died (codes=%s); out of restarts",
                                     i, codes)
                        done[i] = True
                        failed = True
    finally:
        for procs in groups:
            _reap(procs)
        if own_lighthouse is not None:
            own_lighthouse.shutdown()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)

    code = 1 if (failed or stop.is_set()) else 0
    logger.info("launcher done: rc %d, restarts %s", code, restarts)
    return code


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="torchft_tpu_torch_launcher",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("script", nargs="?", default=None,
                        help="worker script (run with this python)")
    parser.add_argument("-m", "--module", default=None,
                        help="run the worker as `python -m MODULE` instead of a script")
    parser.add_argument("--replica-groups", type=int, default=2)
    parser.add_argument("--workers-per-replica", type=int, default=1)
    parser.add_argument("--lighthouse", default=None,
                        help="an existing lighthouse's address; else one is started")
    parser.add_argument("--min-replicas", type=int, default=None)
    parser.add_argument("--max-restarts", type=int, default=0)

    # everything after a literal `--` goes verbatim to the worker
    if argv is None:
        argv = sys.argv[1:]
    worker_args: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, worker_args = argv[:split], argv[split + 1:]
    ns = parser.parse_args(argv)
    if (ns.script is None) == (ns.module is None):
        parser.error("give a worker script or -m MODULE, not both")
    entry = [ns.script] if ns.module is None else ["-m", ns.module]

    logging.basicConfig(level=logging.INFO)
    sys.exit(launch_replica_groups(
        [sys.executable, *entry, *worker_args],
        num_groups=ns.replica_groups,
        workers_per_replica=ns.workers_per_replica,
        lighthouse_addr=ns.lighthouse,
        min_replicas=ns.min_replicas,
        max_restarts=ns.max_restarts,
    ))


if __name__ == "__main__":
    main()
