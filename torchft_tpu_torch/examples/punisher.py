"""The chaos tool: kill replica groups through the lighthouse to exercise
fault tolerance (the port's counterpart of ``examples/punisher.py``).

The lighthouse serves ``/status`` (JSON: the quorum's participants and the
heartbeat ages) and ``POST /replica/{id}/kill``, which forwards a kill RPC
to that replica's manager server; the native server exits its process
(``_exit(1)``). Only a group's leader runs a manager server, so the kill
reaches the leader's process alone; the launcher
(``torchft_tpu_torch.launcher``) then takes the group's other workers down
and restarts the group, which rejoins and heals (or restores its durable
checkpoint).

Modes:
  kill_one   kill one replica (random, or ``--replica-id``) and exit
  kill_all   kill every replica the lighthouse knows
  kill_loop  kill at exponentially distributed intervals of mean ``--mtbf``

    python -m torchft_tpu_torch.examples.punisher --lighthouse 127.0.0.1:29510 kill_one
    python -m torchft_tpu_torch.examples.punisher --lighthouse 127.0.0.1:29510 kill_loop --mtbf 60
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional

__all__ = ["kill", "kill_all", "kill_loop", "kill_one", "list_replicas", "main"]


def _base(addr: str) -> str:
    return addr if addr.startswith("http") else f"http://{addr}"


def list_replicas(lighthouse: str) -> List[str]:
    """Every replica id the lighthouse's ``/status`` names: those in a
    quorum call now (bare ids) and the last quorum's members (objects)."""
    with urllib.request.urlopen(f"{_base(lighthouse)}/status", timeout=10) as r:
        status = json.loads(r.read().decode())
    ids = {p if isinstance(p, str) else p["replica_id"] for p in status.get("participants", [])}
    if status.get("prev_quorum"):
        ids |= {p["replica_id"] for p in status["prev_quorum"].get("participants", [])}
    return sorted(ids)


def kill(lighthouse: str, replica_id: str) -> bool:
    req = urllib.request.Request(f"{_base(lighthouse)}/replica/{replica_id}/kill", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            print(f"killed {replica_id}: {r.read().decode().strip()}", flush=True)
        return True
    except urllib.error.HTTPError as e:
        print(f"kill {replica_id} failed: {e}", file=sys.stderr, flush=True)
        return False


def kill_one(lighthouse: str, replica_id: Optional[str] = None) -> int:
    replicas = list_replicas(lighthouse)
    if not replicas:
        print("no replicas known to the lighthouse", file=sys.stderr)
        return 1
    victim = replica_id if replica_id is not None else random.choice(replicas)
    return 0 if kill(lighthouse, victim) else 1


def kill_all(lighthouse: str) -> int:
    rc = 0
    for r in list_replicas(lighthouse):
        rc |= 0 if kill(lighthouse, r) else 1
    return rc


def kill_loop(lighthouse: str, mtbf: float, max_kills: int = 0) -> int:
    """Kills at exponentially distributed intervals of mean ``mtbf``
    seconds, ``max_kills`` of them (0: until stopped)."""
    kills = 0
    while max_kills <= 0 or kills < max_kills:
        delay = random.expovariate(1.0 / mtbf)
        print(f"next kill in {delay:.1f}s", flush=True)
        time.sleep(delay)
        try:
            if kill_one(lighthouse) == 0:
                kills += 1
        except Exception as e:  # noqa: BLE001 - the lighthouse may be restarting
            print(f"kill attempt failed: {e}", file=sys.stderr, flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lighthouse", required=True, help="host:port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    one = sub.add_parser("kill_one")
    one.add_argument("--replica-id", default=None)
    sub.add_parser("kill_all")
    loop = sub.add_parser("kill_loop")
    loop.add_argument("--mtbf", type=float, default=60.0, help="mean seconds between kills")
    loop.add_argument("--max-kills", type=int, default=0, help="0: forever")
    args = parser.parse_args(argv)

    if args.cmd == "kill_one":
        sys.exit(kill_one(args.lighthouse, args.replica_id))
    elif args.cmd == "kill_all":
        sys.exit(kill_all(args.lighthouse))
    else:
        sys.exit(kill_loop(args.lighthouse, args.mtbf, args.max_kills))


if __name__ == "__main__":
    main()
