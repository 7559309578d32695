"""Declared observability contract of the port: the single list of every
key that is allowed to flow through ``Manager.timings()`` and the
manager-side Prometheus exporter.

Counterpart of ``torchft_tpu/analysis/contracts.py``, declaring what the
port emits and nothing else. The counter-contract checker
(``torchft_tpu_torch/analysis/counter_contract.py``) statically extracts
the keys ``manager.py`` / ``redundancy.py`` actually emit and diffs both
directions: an emitted key missing here is *undeclared* (new telemetry
must land with a declaration and a row in the README's ``### Counters``),
and a key declared here that no longer appears in code is a *dead
declaration* (emission was removed without updating the contract). Every
declared key must also be mentioned in the README's ``### Counters``.

Against the reference's contract: ``standby_send_s``,
``reconstruct_shards_ok`` and ``shard_put_s`` are the port's own; the
degrade plane's ``degrade_events``, ``degraded_reshard_s`` and
``restored_events`` join with their plane (``ROADMAP.md``, item 6).
"""

from __future__ import annotations

from typing import Dict

# key -> one-line meaning (kept short: the README's ### Counters is the
# operator-facing reference; this is the machine-checked index)
DECLARED_TIMINGS: Dict[str, str] = {
    # quorum / reconfigure phases
    "quorum_overlap_s": "control-plane time on the quorum thread",
    "configure_prepare_s": "overlappable half of the PG reconfigure",
    "configure_commit_s": "serializing half of the PG reconfigure",
    "should_commit_rpc_s": "commit-vote RPC wall clock",
    "bookkeeping_s": "residual commit-path bookkeeping",
    # heal plane
    "heal_send_s": "serving a live checkpoint to a peer",
    "standby_send_s": "staging a standby snapshot for a heal's fallback",
    "heal_recv_s": "fetching + applying a live checkpoint",
    "heal_chunks": "chunks in the last heal stream",
    "heal_mb_per_s": "last heal stream throughput",
    "heal_attempts": "cumulative heal tries (incl. same-source retries)",
    "heal_failovers": "cumulative mid-heal source switches",
    "chunk_crc_failures": "chunks refetched after integrity mismatch",
    # allreduce pipeline
    "allreduce_s": "submission-to-resolve wall clock of the last allreduce",
    "allreduce_pack_s": "summed per-bucket pack stage",
    "allreduce_wire_s": "summed per-bucket wire stage",
    "allreduce_unpack_s": "summed per-bucket unpack stage",
    "allreduce_buckets": "buckets in the last streamed allreduce",
    "overlap_efficiency": "fraction of wire time hidden behind other stages",
    "collective_reroute": "cumulative mid-collective link reroutes",
    # control plane (two-level)
    "via_aggregator": "1 when control RPCs ride the pod aggregator",
    "aggregator_failovers": "cumulative aggregator→root failovers",
    "rpc_retries": "cumulative retried control-plane RPCs",
    # health plane
    "health_state": "lighthouse health state code for this replica",
    "straggler_score": "quorum-relative modified z-score",
    "ejections": "cumulative proactive ejections of this replica",
    "readmissions": "cumulative probationary readmissions",
    # policy plane (adaptive FT control, quorum-safe-point application)
    "policy_seq": "latest policy frame sequence seen at a safe point",
    "policy_applies": "frames whose overrides were enforced live",
    "policy_intents": "frames recorded in observe mode (no knob touched)",
    # observability honesty counters
    "dropped_events": "telemetry events shed by the bounded drain",
    "trace_dropped": "spans overwritten in the trace ring",
    # serving plane (commit-path publisher)
    "serve_publish_s": "commit-path snapshot handoff wall clock",
    "serve_published_total": "snapshots handed to the publisher",
    "serve_publish_errors_total": "failed snapshot handoffs",
    # redundancy plane — manager side
    "shard_stage_hot_s": "hot-path cost of handing state to the stager",
    "standby_skipped": "standby snapshots refused while mid-heal",
    "reconstructs": "heals satisfied by parallel shard reconstruct",
    "reconstruct_failures": "reconstruct attempts that fell back to pull",
    "reconstruct_s": "last parallel reconstruct wall clock",
    "reconstruct_mb_per_s": "last parallel reconstruct throughput",
    "reconstruct_shards_ok": "shards the last reconstruct fetched intact",
    "shard_corrupt": "shards that failed crc32 on the GET path",
    "shard_fetch_failed": "shard GETs that failed outright",
    "spare_promote_step": "step at which this spare was promoted",
    # redundancy plane — stager/spare bridge (_on_metric)
    "shard_stage_s": "staging wall clock off the hot path",
    "shard_stage_snapshot_s": "hot-path state snapshot cost",
    "shard_encode_s": "GF(256) parity encode wall clock",
    "shard_put_s": "last generation's shard PUTs wall clock",
    "shard_stage_bytes": "bytes in the last staged state blob",
    "shards_staged": "cumulative shards PUT to peer stores",
    "shard_stage_skipped": "stagings skipped by the interval knob",
    "shard_stage_dropped": "stagings dropped by newest-wins queueing",
    "shard_stage_failed": "stagings that failed end to end",
    "shard_put_failed": "individual shard PUTs that failed",
    "shard_announce_rejected": "directory announces rejected as stale",
    "spare_prefetch_s": "hot-spare decode-ahead wall clock",
    "spare_prefetch_steps": "generations prefetched by the hot spare",
}

# explicit Prometheus series registered on the manager exporter (beyond
# the mechanical torchft_manager_<timings-key> projections)
DECLARED_SERIES: Dict[str, str] = {
    "torchft_manager_step": "current manager step",
    "torchft_manager_quorum_id": "current PG generation",
    "torchft_manager_trace_spans_total": "spans recorded into the ring",
    "torchft_manager_clock_skew_ms": "heartbeat-derived skew estimate",
    "torchft_manager_clock_skew_rtt_ms": "RTT of the best skew sample",
}
