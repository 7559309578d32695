"""Standalone lighthouse CLI of the port.

Counterpart of ``torchft_tpu/lighthouse.py:24-127`` over the port's native
``LighthouseServer``. Run one lighthouse per job::

    python -m torchft_tpu_torch.lighthouse --min-replicas 2 --bind 0.0.0.0:29510

and point workers at it with ``TORCHFT_LIGHTHOUSE=host:port``. It logs
``lighthouse listening at <address>`` once it serves, and exits with 0 on
SIGINT or SIGTERM. Each flag also takes its underscore spelling
(``--min_replicas``). ``--redundancy-directory`` (reference ``:65``)
co-hosts the redundancy plane's shard directory and logs ``shard
directory serving at <url> (epoch <epoch>)``; point replicas at it with
``TORCHFT_REDUNDANCY_DIRECTORY=<url>``. ``--history PATH`` (reference
``:42-49``) records an append-only JSONL of quorum transitions, heals,
health events and telemetry snapshots; fold it with ``python -m
torchft_tpu_torch.trace history PATH``. The health ledger takes
``TORCHFT_HEALTH_*`` from the environment (``healthwatch.HealthConfig``,
read by ``LighthouseServer``:
``TORCHFT_HEALTH_MODE=eject`` ejects stragglers; the default observes).
``--serve-registry`` (reference ``:51-60``) co-hosts the serving plane's
snapshot registry, which drains a source at ``--serve-drain-on`` (``warn``
or ``eject``; default ``$TORCHFT_SERVE_DRAIN_ON``, else ``warn``) of this
lighthouse's health ledger, and logs ``snapshot registry serving at <url>
(epoch <epoch>)``; point publishers and workers at it with
``TORCHFT_SERVE_REGISTRY=<url>``. ``--policy PATH|builtin`` (reference
``:74-104``) attaches the adaptive policy engine (``policy.py``) and logs
``policy engine attached (spec=<spec> mode=<mode>)``; the mode is
``TORCHFT_POLICY`` (``off`` by default, which attaches nothing), and the
Managers' own ``TORCHFT_POLICY`` decides what they do with its frames.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
from typing import List, Optional

from torchft_tpu_torch.coordination import LighthouseServer

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="torchft_tpu_torch.lighthouse", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--bind", default="0.0.0.0:29510")
    parser.add_argument("--min-replicas", "--min_replicas", type=int, default=1)
    parser.add_argument("--join-timeout-ms", "--join_timeout_ms", type=int, default=60000)
    parser.add_argument("--quorum-tick-ms", "--quorum_tick_ms", type=int, default=100)
    parser.add_argument("--heartbeat-timeout-ms", "--heartbeat_timeout_ms", type=int,
                        default=5000)
    parser.add_argument("--serve-registry", "--serve_registry", action="store_true",
                        help="co-host a serving-plane snapshot registry that health-gates "
                             "inference routing off this lighthouse's /health ledger; point "
                             "publishers and workers at it with TORCHFT_SERVE_REGISTRY")
    parser.add_argument("--serve-drain-on", "--serve_drain_on", default=None,
                        choices=("warn", "eject"),
                        help="health state at which the registry drains a serving source "
                             "(default: $TORCHFT_SERVE_DRAIN_ON or warn)")
    parser.add_argument("--redundancy-directory", "--redundancy_directory", action="store_true",
                        help="co-host a redundancy-plane shard directory: it tracks "
                             "erasure-coded shard placements, detects owner deaths and "
                             "promotes hot spares; point replicas at it with "
                             "TORCHFT_REDUNDANCY_DIRECTORY")
    parser.add_argument("--history", default="", metavar="PATH",
                        help="append-only JSONL of quorum transitions, heals, health events "
                             "and telemetry snapshots; fold it with `python -m "
                             "torchft_tpu_torch.trace history PATH` (default: off)")
    parser.add_argument("--policy", default=None, metavar="PATH|builtin",
                        help="attach the adaptive policy engine: a PolicySpec JSON file or "
                             "'builtin'. Frames ride the heartbeat and agg_tick replies; "
                             "TORCHFT_POLICY (off|observe|enforce, default off) governs what "
                             "the Managers do with them. Replay candidates first: `python -m "
                             "torchft_tpu_torch.policy replay --history F --policy A B`")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        redundancy_directory=args.redundancy_directory,
        history_path=args.history,
        serve_registry=args.serve_registry,
        serve_drain_on=args.serve_drain_on,
        policy=args.policy,
    )
    try:
        logging.info("lighthouse listening at %s", server.address())
        if server.serve_registry is not None:
            logging.info("snapshot registry serving at %s (epoch %s)",
                         server.serve_registry.url, server.serve_registry.epoch)
        if server.redundancy_directory is not None:
            logging.info("shard directory serving at %s (epoch %s)",
                         server.redundancy_directory.url, server.redundancy_directory.epoch)
        if server.policy_controller is not None:
            logging.info("policy engine attached (spec=%s mode=%s)", args.policy,
                         server.policy_mode)
        stop.wait()
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
