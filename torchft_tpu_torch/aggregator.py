"""The pod aggregator's CLI (the two-level control plane): the port's
counterpart of ``torchft_tpu/aggregator.py``.

Run one aggregator a pod of replica groups::

    python -m torchft_tpu_torch.aggregator --root 127.0.0.1:29510 --bind 0.0.0.0:29520

and point the pod's workers at it with
``TORCHFT_LIGHTHOUSE_AGGREGATOR=host:29520``, keeping ``TORCHFT_LIGHTHOUSE``
at the root for the failover: a Manager speaks the lighthouse's protocol to
an aggregator, which batches the pod's heartbeats and telemetry into one
delta-encoded ``agg_tick`` RPC a tick to the root and fans quorum results
back out. Its port also serves ``GET /status`` (pod size, live set, the
upstream ticks). It logs ``aggregator listening at host:port (root ...)``
and exits 0 on SIGINT or SIGTERM.

``check_aggregator()`` is the reference doctor's aggregator check
(``torchft_tpu/doctor.py:461``), which the port's doctor runs: the environment's wiring, then a beat
through an aggregator on loopback that must reach a root lighthouse as a
batched ``agg_tick``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading
import time
from typing import List, Optional, Tuple

from torchft_tpu_torch import knobs
from torchft_tpu_torch.coordination import AggregatorServer, LighthouseClient, LighthouseServer

__all__ = ["AGGREGATOR_ENV", "check_aggregator", "main"]

# Managers read this to point their control RPCs at a pod aggregator
# (manager.py names it too), and fail over to TORCHFT_LIGHTHOUSE
AGGREGATOR_ENV = "TORCHFT_LIGHTHOUSE_AGGREGATOR"
LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"


def check_aggregator() -> Tuple[bool, str]:
    """``(ok, detail)``: ``TORCHFT_LIGHTHOUSE_AGGREGATOR`` is unset or a
    ``host:port`` with ``TORCHFT_LIGHTHOUSE`` beside it (the pod's way back
    to the root), and a beat sent to an aggregator reaches a root lighthouse
    through ``agg_tick``, not as a direct heartbeat."""
    env_note = "flat fleet (no aggregator env)"
    agg_env = knobs.env_raw(AGGREGATOR_ENV, "")
    if agg_env:
        host, sep, port = agg_env.replace("http://", "").rpartition(":")
        if not sep or not host or not port.isdigit():
            return False, (f"{AGGREGATOR_ENV}={agg_env!r} is not host:port — managers will "
                           "fail to start")
        lighthouse = knobs.env_raw(LIGHTHOUSE_ENV, "")
        if not lighthouse:
            return False, (f"{AGGREGATOR_ENV} is set but {LIGHTHOUSE_ENV} is not: the pod cannot "
                           "fail over to the root if its aggregator dies — set both")
        env_note = f"two-level ({agg_env} -> {lighthouse})"
    try:
        root = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                                quorum_tick_ms=20, heartbeat_timeout_ms=2000)
        agg = None
        try:
            agg = AggregatorServer(root_addr=f"127.0.0.1:{root.port}", bind="127.0.0.1:0",
                                   agg_id="doctor_pod", tick_ms=50)
            resp = LighthouseClient(f"127.0.0.1:{agg.port}", connect_timeout=5.0).heartbeat(
                "doctor", timeout=5.0)
            if not resp.get("aggregated"):
                return False, "aggregator heartbeat response not marked aggregated"
            root_client = LighthouseClient(f"127.0.0.1:{root.port}", connect_timeout=5.0)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                st = root_client.status(timeout=5.0)
                if "doctor" in st.get("heartbeat_ages_ms", {}):
                    if st.get("rx", {}).get("heartbeat", {}).get("calls", 0):
                        return False, ("beat reached the root as a DIRECT heartbeat — the "
                                       "aggregator forwarded instead of batching")
                    ticks = st["aggregators"]["doctor_pod"]["ticks"]
                    return True, (f"{env_note}; loopback beat reached root via agg_tick "
                                  f"({ticks} ticks)")
                time.sleep(0.05)
            return False, "beat sent to the aggregator never reached the root lighthouse"
        finally:
            if agg is not None:
                agg.shutdown()
            root.shutdown()
    except Exception as e:  # noqa: BLE001 - a check reports, never raises
        return False, f"{type(e).__name__}: {e}"


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="torchft_tpu_torch_aggregator",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="root lighthouse address (host:port; an http:// prefix is taken)")
    parser.add_argument("--bind", default="0.0.0.0:29520")
    parser.add_argument("--agg-id", "--agg_id", default="",
                        help="stable aggregator id (default: from the bind address)")
    parser.add_argument("--tick-ms", "--tick_ms", type=int, default=100,
                        help="upstream batching cadence: one agg_tick RPC a tick")
    parser.add_argument("--heartbeat-timeout-ms", "--heartbeat_timeout_ms", type=int,
                        default=5000, help="the pod's liveness horizon; match the root's")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server = AggregatorServer(root_addr=args.root, bind=args.bind, agg_id=args.agg_id,
                              tick_ms=args.tick_ms,
                              heartbeat_timeout_ms=args.heartbeat_timeout_ms)
    try:
        logging.info("aggregator listening at %s (root %s)", server.address(), args.root)
        stop.wait()
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
