"""Manager: the per-worker fault-tolerance state machine.

Counterpart of ``torchft_tpu/manager.py``'s main path: the quorum
lifecycle on a one-thread executor (``start_quorum``, ``:767``; async body
``:1039``), process-group reconfiguration per quorum, live healing over the
checkpoint transport (``:1177-1246``, ``_recv_checkpoint`` ``:1397``), the
managed allreduce (``:1679``, ``allreduce_streamed`` ``:1695``) with errors
swallowed into a zeros result, and the two-phase commit
(``should_commit``, ``:3202``).

A replica group is one worker or several (``group_world_size``, reference
``:230-232``, ``:348-389``): group rank 0 leads it, owning the rendezvous
store (unless ``store_addr`` names one) and the manager server, which
barriers the group's ranks at every quorum and ANDs their commit votes,
and publishes the server's address in the store as ``manager_addr``; every
other rank reads it there. Each rank quorums, votes, forms its
cross-group process group (store prefix ``.../torchft/{quorum_id}/{group
rank}``) and heals from the same group rank of a healthy group.

The quorum is async by default (``use_async_quorum``, ``:224``): it runs
on the quorum thread while the step computes, and a healing replica sits
its first step out.
With ``use_async_quorum=False`` (what DiLoCo needs) ``start_quorum`` waits
for the quorum and applies a heal there and then (``:767-842``), so the
healed replica takes part in the same step; a process group that says
``requires_sync_quorum`` forces it, re-read at every ``start_quorum``
(``:248-265``, ``:785-800``). ``start_quorum(allow_heal=False)`` neither
serves nor receives a heal; ``shrink_only`` and ``timeout`` go to the
quorum RPC. Under ``WorldSizeMode.FIXED_WITH_SPARES`` at most
``min_replica_size`` replicas contribute and the rest are spares
(``:1074-1086``). ``should_commit`` raises once the vote failed more than
``max_retries`` times in a row.

A reconfigure has two halves (``:1110-1175``, ``:1479``): the quorum thread
runs the process group's ``prepare_configure``, and the commit it returns,
if any, runs on the main thread at the next safe point (``start_quorum``,
``allreduce``, ``should_commit``); ``timings()`` carries
``configure_prepare_s``, ``configure_commit_s`` and ``quorum_overlap_s``.
The heal rides ``checkpoint_transport`` (``:233``, ``:308-315``): the
port's ``HTTPTransport`` by default, or a ``PGTransport`` over a recovery
process group of its own, which the Manager reconfigures with its PG at
every new quorum under the ``.../recovery/{group_rank}`` store prefix. A
transport that ``supports_multi_source`` (HTTP) heals from the assigned
source and fails over, mid-chunk, to the other up-to-date peers the quorum
names (``_heal_sources``, ``:1263``); those peers stage a standby snapshot
while a heal is under way and hold it open across their commits
(``:1183-1225``). Both manager clients retry their RPCs under the
``TORCHFT_RETRY_*`` policy; ``timings()`` counts ``rpc_retries``,
``heal_attempts``, ``heal_failovers`` and ``chunk_crc_failures``.

The allreduce takes the reference's host-plane paths. By default (as the
reference's) a multi-leaf tree STREAMS (``:1891-2200``): ``bucketing``
packs it into buckets of at most ``bucket_cap_bytes`` (1 GiB), and each
bucket is one collective, three stages deep: pack (the concatenation and,
when compressed, the coding, with error feedback), wire (the PG's dispatch
thread), unpack (decode, AVG divide, slice and land, on the unpack
worker), so bucket i+1 packs while bucket i is on the wire. Buckets ride
compressed (fp8 or int8, with per-bucket error-feedback residuals) when
``should_quantize`` is set or ``TORCHFT_COMPRESS`` asks; a bucket on the
card is coded there by the fp8 kernels and only its codes cross to the
host. Without streaming (``stream_buckets=False``), and for a single leaf,
the SERIAL path: one collective for the whole tree on one ordered staging
thread, fp8-quantized through ``collectives.allreduce_quantized`` when
asked (CUDA tensors take its device engine); an unquantized tree is
bucketed into that one collective. A non-participant contributes zeros and
never touches the residuals.

The redundancy plane (``redundancy.py``; reference ``:630-680``,
``:797-805``, ``:1326-1414``, ``:2818-2943``) attaches when
``TORCHFT_REDUNDANCY_K`` >= 1 and a shard directory is configured (each
``TORCHFT_REDUNDANCY_*`` variable > the ``redundancy`` config's field >
default): the group leader stages its committed state at the start of
the round after each commit (``shard_stage_hot_s``, in ``timings()`` on
a round that staged, is what the step pays), and a heal first tries
``reconstruct_state`` of the quorum's step, landing in place in
``state_dict_template()``, before the peer pull; a failed reconstruct
bumps ``reconstruct_failures`` and falls back to the pull.
``spare=True`` makes a hot spare: no store, no manager server, no
lighthouse heartbeat until ``promote()`` returns (it waits for the
directory's promotion, loads the prefetched generation through the
registered load fns, in place, and joins the control plane). With
``k == 0`` nothing of the plane runs. The plane stages and heals a whole
one-rank group: a group of more ranks with the plane on raises
``ValueError`` (each rank would need its own shards).

The health plane (reference ``:511-552``, ``:2939-3105``): after each
vote the group leader hands the step's telemetry (``step_s`` between
votes, the allreduce's ``wire_s``, the resilience counters) to its
heartbeat, and folds the lighthouse's health summary the last beat brought
back into ``timings()`` (``health_state``, ``straggler_score``,
``ejections``, ``readmissions``), with a ``torchft_health`` event, a
flight-recorder breadcrumb and a span instant on every change of state.
An ejected replica's quorum call waits until the lighthouse readmits it;
it then heals like any replica behind. ``set_telemetry_transform``
rewrites the telemetry (tests). Observability (reference ``:585-626``,
``:2457-2776``): a span recorder (``tracer``, ``dump_trace``) records the
quorum RPC, the reconfigure's halves, the heal's send and receive, the
redundancy plane's ``reconstruct`` and ``shard_stage``, the commit vote,
each streamed bucket's pack, wire and unpack, and instants for retries,
re-routes, heal and shard events; the wait for the quorum, the quorum
thread, the allreduce, the commit and the reconfigure's halves are also
``torch.profiler`` ranges (``torchft::manager::...``). The structured
streams (``observability.py``) carry quorum, commit, error, timing and
health events; the flight recorder is dumped on a reported error, an
exhausted heal and an ejection. ``metrics_port`` serves ``/metrics``.
The device-plane streaming branch (an XLA process group) and the degrade
plane are not ported yet.

The policy plane (reference ``:523-541``, ``:850-991``; ``policy.py``):
with ``TORCHFT_POLICY`` other than ``off``, ``start_quorum`` reads the
newest frame off the heartbeat mirror after its per-step resets and
before it submits the quorum, and acts on a new ``policy_seq`` once: in
observe mode it records an intent (``policy_intents``), in enforce mode
(the Manager's and the frame's) it installs the frame's overrides in
``knobs``, reverts the ones a later frame released, runs each knob's
``register_policy_adjuster`` setter and retargets ``TORCHFT_COMPRESS``
(``policy_applies``). ``policy_seq``, ``policy_applies`` and
``policy_intents`` are in ``timings()`` and on ``/metrics``;
``policy_status()`` is the operator's view.

Knobs, each environment variable > constructor argument > default:
``TORCHFT_TIMEOUT_SEC`` / ``timeout``, ``TORCHFT_QUORUM_TIMEOUT_SEC`` /
``quorum_timeout`` (``timeout``), ``TORCHFT_CONNECT_TIMEOUT_SEC`` /
``connect_timeout`` (10 s), ``TORCHFT_QUORUM_RETRIES`` / ``quorum_retries``
(0; the argument wins here, as the reference's), ``TORCHFT_BUCKET_CAP_MB`` / ``bucket_cap_bytes`` (1 GiB; 0 disables
bucketing), ``TORCHFT_STREAM_BUCKETS`` / ``stream_buckets`` (on; "0",
"false", "no" or "off" turn it off), ``TORCHFT_COMPRESS`` / ``compress``
("off", "fp8" or "int8"; "off", and ``should_quantize`` picks fp8).
Two are the other way round, as in the reference: ``tracing`` >
``TORCHFT_TRACE`` (on), and ``metrics_port`` > ``TORCHFT_METRICS_PORT``
(none). The lighthouse's ``TORCHFT_HEALTH_*`` (``healthwatch.py``) decide
what the telemetry does.
"""

from __future__ import annotations

import logging
import os
import socket as _socket
import threading
import time
import traceback
import uuid
import weakref
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

import torchft_tpu_torch.flight_recorder as _fr
from torchft_tpu_torch import bucketing, knobs
from torchft_tpu_torch.checkpointing import CheckpointTransport, HTTPTransport, RWLock
from torchft_tpu_torch.checkpointing._serialization import place_state_like
from torchft_tpu_torch.coordination import (
    KvClient,
    KvStoreServer,
    ManagerClient,
    ManagerServer,
)
from torchft_tpu_torch.futures import arm_deadline
from torchft_tpu_torch.observability import (
    ALLREDUCE_PIPELINE_PHASE,
    COMMIT_EVENTS,
    HEALTH_EVENTS,
    METRICS_PORT_ENV,
    POLICY_EVENTS,
    TIMING_EVENTS,
    MetricsRegistry,
    MetricsServer,
    emit_event_async,
    get_event_drain,
    log_error_event,
    log_quorum_event,
    trace_span,
    traced,
)
from torchft_tpu_torch.ops.quantization import (
    compress_bucket,
    decompress_bucket,
    is_compressed_wire,
    resolve_compress_mode,
)
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.redundancy import (
    REDUNDANCY_DIRECTORY_ENV,
    HotSpare,
    RedundancyConfig,
    ShardStager,
    reconstruct_state,
)
from torchft_tpu_torch.tracing import TRACE_BUFFER_ENV, SpanRecorder, TraceConfig
from torchft_tpu_torch.utils import true_divide
from torchft_tpu_torch.work import (
    DummyWork,
    Future,
    FutureWork,
    GradStream,
    Work,
    join_futures,
)

logger = logging.getLogger(__name__)

__all__ = ["Manager", "ExceptionWithTraceback", "WorldSizeMode"]

LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"
# the pod aggregator of the two-level control plane (reference :92-95): the
# group leader's manager server sends its heartbeats and quorum RPCs there
# and fails over to the lighthouse on its own when it dies
AGGREGATOR_ENV = "TORCHFT_LIGHTHOUSE_AGGREGATOR"
TIMEOUT_SEC_ENV = "TORCHFT_TIMEOUT_SEC"
QUORUM_TIMEOUT_SEC_ENV = "TORCHFT_QUORUM_TIMEOUT_SEC"
CONNECT_TIMEOUT_SEC_ENV = "TORCHFT_CONNECT_TIMEOUT_SEC"
QUORUM_RETRIES_ENV = "TORCHFT_QUORUM_RETRIES"
BUCKET_CAP_MB_ENV = "TORCHFT_BUCKET_CAP_MB"
STREAM_BUCKETS_ENV = "TORCHFT_STREAM_BUCKETS"
# the group leader's ManagerServer binds this port (0: any free one), as a
# spare's does when promote() starts it
MANAGER_PORT_ENV = "TORCHFT_MANAGER_PORT"
# cumulative resilience counters, kept in timings()
_COUNTERS = ("heal_attempts", "heal_failovers", "rpc_retries", "chunk_crc_failures",
             "collective_reroute", "standby_skipped",
             # the redundancy plane: staging and reconstruct
             "shards_staged", "shard_stage_skipped", "shard_stage_dropped",
             "shard_stage_failed", "shard_put_failed", "shard_announce_rejected",
             "reconstructs", "reconstruct_failures", "shard_corrupt", "shard_fetch_failed",
             # the serving plane's publishes (attach_serve_publisher)
             "serve_published_total", "serve_publish_errors_total",
             # the policy plane's frames applied (enforce) and only recorded
             # (observe) at the safe point; policy_seq is a gauge
             "policy_applies", "policy_intents")
# timings() keys /metrics renders as counters (``_total``): the bumped ones,
# the health plane's cumulative ejections and readmissions (the lighthouse
# counts them) and the observability planes' losses; every other number is
# a last-value gauge
_COUNTER_TIMINGS = frozenset(_COUNTERS) | {"ejections", "readmissions", "dropped_events",
                                           "trace_dropped"}
# the healthwatch summary's keys in timings(), 0 until a heartbeat brings one
_HEALTH_TIMINGS = ("health_state", "straggler_score", "ejections", "readmissions")
# the health state's transitions as the torchft_health stream names them
_HEALTH_TRANSITIONS = {"warn": "straggler_warn", "ejected": "eject", "probation": "readmit",
                       "ok": "recovered", "degraded": "degrade_acked"}


def _to_seconds(t: "float | timedelta") -> float:
    return t.total_seconds() if isinstance(t, timedelta) else float(t)


class WorldSizeMode(Enum):
    """Gradient semantics under a changing world size.

    DYNAMIC: any quorum of at least ``min_replica_size`` contributes; the
    batch size varies. FIXED_WITH_SPARES: at most ``min_replica_size``
    replicas contribute and the rest are hot spares contributing zeros, so
    the gradient's scale stays fixed."""

    DYNAMIC = "dynamic"
    FIXED_WITH_SPARES = "fixed_with_spares"


class ExceptionWithTraceback(Exception):
    def __init__(self, e: Exception) -> None:
        self.original_exception = e
        self.stack_trace = traceback.format_exc()
        super().__init__(f"{e}\n{self.stack_trace}")


def _is_float_leaf(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _leaf_device(x: Any) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _place(orig: Any, reduced: Any) -> Any:
    """A reduced value landed as its original leaf: a tensor on the leaf's
    device in its dtype, or an ndarray for an array leaf."""
    if isinstance(orig, torch.Tensor):
        if not isinstance(reduced, torch.Tensor):
            reduced = torch.from_numpy(np.ascontiguousarray(reduced))
        return reduced.to(device=orig.device, dtype=orig.dtype)
    if isinstance(reduced, torch.Tensor):
        reduced = reduced.cpu().numpy()
    return np.asarray(reduced)


class Manager:
    """Fault-tolerance manager for one worker of one replica group::

        manager = Manager(pg=ProcessGroupHost(), load_state_dict=load_fn,
                          state_dict=state_fn, min_replica_size=1)
        for batch in data:
            manager.start_quorum()
            grads = ...                      # forward + backward
            avg = manager.allreduce(grads, should_quantize=True).get_future().wait()
            if manager.should_commit():
                apply(avg)
    """

    def __init__(
        self,
        pg: ProcessGroup,
        load_state_dict: Optional[Callable[[Any], None]],
        state_dict: Optional[Callable[[], Any]],
        min_replica_size: int,
        use_async_quorum: bool = True,
        timeout: "float | timedelta" = 60.0,
        quorum_timeout: "float | timedelta | None" = None,
        connect_timeout: "float | timedelta | None" = None,
        replica_id: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        init_sync: bool = True,
        hostname: str = "",
        bucket_cap_bytes: Optional[int] = None,
        stream_buckets: Optional[bool] = None,
        compress: Optional[str] = None,
        checkpoint_transport: Optional[CheckpointTransport] = None,
        store_addr: Optional[str] = None,
        group_rank: int = 0,
        group_world_size: int = 1,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        max_retries: Optional[int] = None,
        quorum_retries: Optional[int] = None,
        spare: bool = False,
        redundancy: Optional[RedundancyConfig] = None,
        heartbeat_interval: "float | timedelta" = 0.1,
        tracing: Optional[bool] = None,
        metrics_port: Optional[int] = None,
    ) -> None:
        """``redundancy`` is the plane's config under the
        ``TORCHFT_REDUNDANCY_*`` environment (a variable set wins over its
        field); ``spare=True`` needs its directory. ``heartbeat_interval``
        is the leader's beat to the lighthouse, which carries its per-step
        telemetry. ``tracing`` (over ``TORCHFT_TRACE``, on by default) turns
        the span recorder on or off; ``metrics_port`` (over
        ``TORCHFT_METRICS_PORT``; unset: none, 0: any free port) serves
        ``/metrics``."""
        if group_rank != 0 and store_addr is None:
            raise ValueError("a group rank other than 0 needs the leader's store_addr")
        # the plane's config is read before anything starts, so a bad one
        # raises with nothing to tear down
        red_cfg = RedundancyConfig.from_env(base=redundancy)
        if spare and not red_cfg.directory:
            raise ValueError("Manager(spare=True) requires a shard directory "
                             f"(${REDUNDANCY_DIRECTORY_ENV})")
        if group_world_size > 1 and (spare or red_cfg.enabled):
            # the leader stages its own ranks' state only, and a heal would
            # land the leader's shards in every rank
            raise ValueError("the redundancy plane serves one-rank replica groups only: this "
                             f"group has {group_world_size} ranks")
        self._pg = pg
        self._heartbeat_interval = _to_seconds(heartbeat_interval)
        set_reroute = getattr(pg, "set_reroute_observer", None)
        if set_reroute is not None:
            set_reroute(self._on_collective_reroute)
        self._min_replica_size = min_replica_size
        # DiLoCo reads this attribute by name (local_sgd.py)
        self._use_async_quorum = use_async_quorum
        # the caller's choice: a process group's requires_sync_quorum
        # overrides it only while the group says so (start_quorum)
        self._requested_async_quorum = use_async_quorum
        if use_async_quorum and getattr(pg, "requires_sync_quorum", False):
            logger.info("pg %s requires sync quorum; overriding use_async_quorum",
                        type(pg).__name__)
            self._use_async_quorum = False
        self._timeout = float(knobs.env_raw(TIMEOUT_SEC_ENV, _to_seconds(timeout)))
        self._quorum_timeout = float(knobs.env_raw(
            QUORUM_TIMEOUT_SEC_ENV,
            _to_seconds(quorum_timeout) if quorum_timeout is not None else self._timeout,
        ))
        self._connect_timeout = float(knobs.env_raw(
            CONNECT_TIMEOUT_SEC_ENV,
            _to_seconds(connect_timeout) if connect_timeout is not None else 10.0,
        ))
        self._replica_world_size_mode = world_size_mode
        self._max_retries = max_retries
        if quorum_retries is None:
            quorum_retries = int(knobs.env_raw(QUORUM_RETRIES_ENV, 0))
        self._init_sync = init_sync

        env_cap = knobs.env_raw(BUCKET_CAP_MB_ENV)
        if env_cap is not None:
            self._bucket_cap_bytes = int(float(env_cap) * 1024 * 1024)
        elif bucket_cap_bytes is not None:
            self._bucket_cap_bytes = int(bucket_cap_bytes)
        else:
            self._bucket_cap_bytes = bucketing.DEFAULT_BUCKET_CAP_BYTES
        env_stream = knobs.env_raw(STREAM_BUCKETS_ENV)
        if env_stream is not None:
            self._stream_buckets = env_stream.strip().lower() not in ("0", "false", "no", "off")
        elif stream_buckets is not None:
            self._stream_buckets = bool(stream_buckets)
        else:
            self._stream_buckets = True
        # raises on a bad value rather than training uncompressed silently
        self._compress = resolve_compress_mode(compress)
        # flat buffers: the EF residuals and the packing of array leaves
        self._buffer_pool = bucketing.BufferPool()
        # per-(plan, bucket) error-feedback residuals: what quantization
        # rounded away at one step is added back before the next step's
        # quantization; weakly keyed, they die with their plan
        self._ef_residuals: "weakref.WeakKeyDictionary[bucketing.BucketPlan, List[Any]]" = (
            weakref.WeakKeyDictionary()
        )
        self._ef_lock = threading.Lock()

        self._state_dict_lock = RWLock(timeout=self._timeout)
        self._load_state_dict_fns: Dict[str, Callable[[Any], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}
        if state_dict is not None and load_state_dict is not None:
            self.register_state_dict_fn("default", load_state_dict, state_dict)

        # the step and quorum every span and breadcrumb carries
        self._step = 0
        self._quorum_id = -1
        hostname = hostname or _socket.gethostname()
        if checkpoint_transport is None:
            # the heal URL uses the hostname the store and manager use
            checkpoint_transport = HTTPTransport(timeout=self._timeout, hostname=hostname)
        self._checkpoint_transport: CheckpointTransport = checkpoint_transport

        self._group_rank = group_rank
        self._store: Optional[KvStoreServer] = None
        self._manager: Optional[ManagerServer] = None
        self._client: Optional[ManagerClient] = None
        self._vote_client: Optional[ManagerClient] = None
        self._store_addr = store_addr
        # a hot spare shadows the fleet without joining the quorum: no
        # store, no manager server, no heartbeat until promote() runs the
        # leader's half of this constructor (_join_control_plane)
        self._spare = spare
        # _start_control_plane's arguments, kept for promote()
        self._spare_join_args: Optional[Tuple[Any, ...]] = None
        if spare:
            if group_rank != 0:
                raise ValueError("Manager(spare=True) is a whole-replica role: only group_rank 0 "
                                 "may construct it")
            self._replica_id = f"{replica_id or 'spare'}:{uuid.uuid4()}"
        elif group_rank == 0:
            self._replica_id = f"{replica_id or 'replica'}:{uuid.uuid4()}"
        else:
            self._replica_id = replica_id or "replica"
        # the span recorder: the argument over TORCHFT_TRACE (on by default)
        trace_cfg = TraceConfig.from_env()
        if tracing is not None:
            trace_cfg.enabled = bool(tracing)
        self._tracer = SpanRecorder(self._replica_id, trace_cfg)
        # the saturation warning of timings() fires once
        self._dropped_events_warned = False
        if spare:
            self._spare_join_args = (hostname, store_addr, lighthouse_addr, group_world_size,
                                     quorum_retries)
        elif group_rank == 0:
            self._start_control_plane(hostname, store_addr, lighthouse_addr, group_world_size,
                                      quorum_retries)
        else:
            manager_addr = KvClient(store_addr, connect_timeout=self._connect_timeout).get(
                "manager_addr", timeout=self._timeout
            ).decode()
            self._connect_clients(manager_addr)

        self._batches_committed = 0
        self._commit_failures = 0
        self._errored: Optional[ExceptionWithTraceback] = None
        self._metrics_lock = threading.Lock()
        self._metrics: Dict[str, int] = {
            "quorums": 0,
            "reconfigures": 0,
            "heals": 0,
            "commits": 0,
            "commit_failures": 0,
            "allreduces": 0,
            "errors": 0,
        }
        # the last quorum cycle's phase seconds and the cumulative
        # resilience counters
        self._timings: Dict[str, float] = {
            name: 0.0 for name in (*_COUNTERS, *_HEALTH_TIMINGS, "policy_seq")}
        # the policy plane (_poll_policy_safe_point; reference :523-541):
        # the mode, the newest frame seen, each knob's live setter and the
        # overrides this Manager last applied (the diff base of a release:
        # the override layer is shared by every Manager of the process)
        self._policy_mode = knobs.env_str("TORCHFT_POLICY", "off").strip() or "off"
        self._policy_seq_seen = -1
        self._policy_adjusters: Dict[str, Callable[[Optional[str]], None]] = {}
        self._policy_overrides_applied: Dict[str, str] = {}
        # healthwatch telemetry (_publish_step_telemetry): the last vote's
        # time, outcome and quorum, the transform tests install, and the
        # last health state seen
        self._last_commit_t: Optional[float] = None
        self._last_vote_committed = False
        self._telemetry_quorum_id: Optional[int] = None
        self._telemetry_transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
        self._last_health_state: Optional[str] = None
        self._healing = False
        self._last_quorum_healed = False
        # the serving plane (attach_serve_publisher): committed snapshots go
        # to this publisher, group leader only
        self._serve_publisher: Optional[Any] = None
        self._serve_params_fn: Optional[Callable[[], Any]] = None
        # True while this replica holds a standby failover snapshot open for
        # a heal under way elsewhere: should_commit keeps the window open
        self._standby_source = False
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        # the main-thread half of a reconfigure, stashed by the quorum thread
        self._pending_pg_commit: Optional[Callable[[], None]] = None
        self._pending_commit_lock = threading.Lock()
        self._participating_replica_rank: Optional[int] = None
        self._participating_replica_world_size = 0
        self._num_replicas = 0

        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torchft_quorum")
        # one ordered worker stages every allreduce: collectives start in
        # caller order on every replica (the host wire matches by arrival)
        self._staging_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_stage"
        )
        # the streamed pipeline's third stage (decode, divide, slice, land)
        # runs here, off the PG's dispatch thread, so the next bucket's
        # wire starts at once
        self._unpack_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_unpack"
        )
        self._quorum_future: Optional[Any] = None

        # /metrics: the argument over TORCHFT_METRICS_PORT, none when both
        # are unset. Histograms fill as timings are recorded, the rest at a
        # scrape (_refresh_metrics). A port in use (two Managers on one
        # host with a fixed port) leaves training without /metrics
        self._metrics_registry: Optional[MetricsRegistry] = None
        self._metrics_server: Optional[MetricsServer] = None
        env_metrics = knobs.env_raw(METRICS_PORT_ENV, "")
        if metrics_port is None and env_metrics != "":
            try:
                metrics_port = int(env_metrics)
            except ValueError:
                self._log(logging.WARNING, f"ignoring invalid {METRICS_PORT_ENV}={env_metrics!r}")
        if metrics_port is not None:
            try:
                registry = MetricsRegistry()
                self._metrics_server = MetricsServer(registry, port=metrics_port,
                                                     refresh=self._refresh_metrics)
                self._metrics_registry = registry
            except OSError as e:
                self._log(logging.WARNING, f"metrics server failed to bind port {metrics_port} "
                                           f"({e}); continuing without /metrics")

        # the redundancy plane (reference :630-680): k == 0 attaches nothing
        self._redundancy_cfg: Optional[RedundancyConfig] = None
        self._shard_stager: Optional[ShardStager] = None
        self._hot_spare: Optional[HotSpare] = None
        self._redundancy_stage_pending = False
        try:
            if spare:
                self._redundancy_cfg = red_cfg
                self._hot_spare = HotSpare(
                    red_cfg, spare_id=self._replica_id,
                    # the serving plane's delta chain too, when a registry is
                    # named (reference :655-660)
                    serve_registry=knobs.env_raw("TORCHFT_SERVE_REGISTRY", "") or None,
                    on_metric=self._on_redundancy_metric)
            elif red_cfg.enabled:
                self._redundancy_cfg = red_cfg
                if group_rank == 0:
                    self._shard_stager = ShardStager(red_cfg, self._replica_id,
                                                     on_metric=self._on_redundancy_metric)
        except Exception:  # noqa: BLE001 - the plane is advisory
            logger.exception("redundancy plane failed to attach; continuing without it")
            self._redundancy_cfg = None
            self._shard_stager = None
        if self._shard_stager is not None:
            # the policy plane retunes the staging cadence and the parity
            # count live; both hold from the next commit's stage
            self._policy_red_defaults = (red_cfg.interval, red_cfg.m)
            self.register_policy_adjuster("TORCHFT_REDUNDANCY_INTERVAL",
                                          self._policy_set_red_interval)
            self.register_policy_adjuster("TORCHFT_REDUNDANCY_M", self._policy_set_red_m)

    def _start_control_plane(
        self, hostname: str, store_addr: Optional[str], lighthouse_addr: Optional[str],
        group_world_size: int, quorum_retries: int,
    ) -> None:
        """The group leader's wiring: the rendezvous store (unless one is
        named), the manager server (which heartbeats the lighthouse) and
        its address published for the other ranks."""
        if store_addr is None:
            self._store = KvStoreServer("0.0.0.0:0")
            store_addr = f"{hostname}:{self._store.port}"
        if lighthouse_addr is None:
            lighthouse_addr = knobs.env_raw(LIGHTHOUSE_ENV)
            if lighthouse_addr is None:
                raise KeyError(LIGHTHOUSE_ENV)
        self._manager = ManagerServer(
            replica_id=self._replica_id,
            lighthouse_addr=lighthouse_addr,
            hostname=hostname,
            bind=f"0.0.0.0:{int(knobs.env_raw(MANAGER_PORT_ENV, 0))}",
            store_addr=store_addr,
            world_size=group_world_size,
            heartbeat_interval=self._heartbeat_interval,
            connect_timeout=self._connect_timeout,
            quorum_retries=quorum_retries,
            aggregator_addr=knobs.env_raw(AGGREGATOR_ENV, "") or "",
        )
        manager_addr = self._manager.address()
        KvClient(store_addr, connect_timeout=self._connect_timeout).set(
            "manager_addr", manager_addr, timeout=self._timeout
        )
        self._store_addr = store_addr
        self._connect_clients(manager_addr)

    def _connect_clients(self, manager_addr: str) -> None:
        self._client = ManagerClient(manager_addr, connect_timeout=self._connect_timeout)
        # the commit vote rides its own client: the quorum thread's RPC is
        # in flight exactly when the main thread votes
        self._vote_client = ManagerClient(manager_addr, connect_timeout=self._connect_timeout)
        # every retried RPC of either client counts in timings()
        self._client.set_retry_observer(self._on_rpc_retry)
        self._vote_client.set_retry_observer(self._on_rpc_retry)

    def _log(self, level: int, msg: str) -> None:
        logger.log(level, f"[{self._replica_id}/{self._group_rank} step {self._step}] {msg}")

    # ------------------------------------------------------------- state fns
    def register_state_dict_fn(
        self, key: str, load_fn: Callable[[Any], None], value_fn: Callable[[], Any]
    ) -> None:
        """Register a named (load, save) pair included in live recovery."""
        with self._state_dict_lock.w_lock():
            self._load_state_dict_fns[key] = load_fn
            self._user_state_dicts[key] = value_fn

    def set_state_dict_fns(
        self, load_state_dict: Callable[[Any], None], state_dict: Callable[[], Any]
    ) -> None:
        """Deprecated alias of ``register_state_dict_fn("default", ...)``
        (the constructor's slot, so replicas registering either way heal
        from each other)."""
        self._log(logging.WARNING, "set_state_dict_fns is deprecated, use register_state_dict_fn")
        self.register_state_dict_fn("default", load_state_dict, state_dict)

    def allow_state_dict_read(self) -> None:
        if self._state_dict_lock.w_locked():
            self._state_dict_lock.w_release()

    def disallow_state_dict_read(self) -> None:
        if not self._state_dict_lock.w_locked():
            self._state_dict_lock.w_acquire()

    # --------------------------------------------------------------- quorum
    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: "float | timedelta | None" = None,
    ) -> None:
        """Start computing a new quorum (on the quorum thread) and ready the
        manager for a new step. Call before the forward pass. Under the
        synchronous quorum it returns once the quorum is in, with a heal
        already applied (``last_quorum_healed()`` true); a failed recovery
        leaves the step's vote to fail. ``allow_heal=False`` neither serves
        nor receives a heal (a replica behind the cohort sits the step
        out); ``shrink_only`` and ``timeout`` (default the quorum timeout)
        go to the quorum RPC."""
        if self._quorum_future is not None:
            self._quorum_future.result()
            # a commit left over from the last quorum lands before the next
            # prepare runs against the old world
            self._commit_pending_configure()
        if (self._requested_async_quorum and not self._use_async_quorum
                and not getattr(self._pg, "requires_sync_quorum", False)):
            self._log(logging.INFO, "pg no longer requires sync quorum; restoring async quorum")
            self._use_async_quorum = True
        with self._metrics_lock:
            self._timings.pop("shard_stage_hot_s", None)
        if self._shard_stager is not None and self._redundancy_stage_pending:
            # the last round committed and the caller applied its update:
            # the state is the generation a healer joining THIS round
            # loads, announced before this round's barrier (reference
            # :797-805)
            self._redundancy_stage_pending = False
            self._stage_redundancy_committed()
        self._errored = None
        self._healing = False
        self._last_quorum_healed = False
        # a policy frame lands here, the safe point: no collective in
        # flight, the last configure committed (off: never polled)
        if self._policy_mode != "off":
            self._poll_policy_safe_point()
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal=allow_heal,
            shrink_only=shrink_only,
            quorum_timeout=_to_seconds(timeout) if timeout is not None else self._quorum_timeout,
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            self._commit_pending_configure()
            if self._healing and self._pending_state_dict is not None:
                # the forward pass runs on the recovered state
                self._apply_pending_state_dict()
            # a failed recovery has reported its error: retry at the next quorum
            self._healing = False

    def wait_quorum(self) -> None:
        if self._quorum_future is None:
            raise RuntimeError("must call start_quorum first")
        with trace_span("torchft::manager::wait_quorum"):
            self._quorum_future.result()

    # --------------------------------------------------------------- policy
    def register_policy_adjuster(self, knob: str, fn: Callable[[Optional[str]], None]) -> None:
        """A live setter of ``knob`` (LocalSGD and DiLoCo register their
        ``sync_every``, the redundancy plane its cadence and parity count).
        In enforce mode it runs at the safe point with the frame's value,
        or with None when a frame releases the knob (the plane restores
        its own value). The last registration of a knob wins."""
        self._policy_adjusters[knob] = fn

    def policy_status(self) -> Dict[str, Any]:
        """The policy plane on this replica: the mode, the newest frame's
        seq, the override layer and the adjusted knobs."""
        with self._metrics_lock:
            seq = int(self._timings.get("policy_seq", 0.0))
        return {
            "mode": self._policy_mode,
            "policy_seq": seq,
            "overrides": knobs.get_overrides(),
            "adjusters": sorted(self._policy_adjusters),
        }

    def _policy_set_red_interval(self, value: Optional[str]) -> None:
        cfg = self._redundancy_cfg
        if cfg is not None:
            cfg.interval = self._policy_red_defaults[0] if value is None else max(1, int(value))

    def _policy_set_red_m(self, value: Optional[str]) -> None:
        cfg = self._redundancy_cfg
        if cfg is not None:
            # within the GF(256) shard limit the config enforces
            cfg.m = (self._policy_red_defaults[1] if value is None
                     else min(max(1, int(value)), 255 - cfg.k))

    def _poll_policy_safe_point(self) -> None:
        """Read the heartbeat mirror's policy frame and act on a new one
        (reference ``:893-991``). Only registered knobs are taken. Observe
        (or a frame that does not say enforce) records an intent; enforce
        also diffs the frame against what this Manager last applied: a
        released knob reverts and its adjuster gets None, a set one is
        installed in ``knobs`` and its adjuster gets the value, and
        ``TORCHFT_COMPRESS`` retargets the wire codec in place. Either is
        recorded in ``timings()``, the ``torchft_policy`` stream, the flight
        recorder and a span instant. Never raises: a bad frame costs a
        logged warning, not a step."""
        try:
            frame = self._manager.policy() if self._manager is not None else {}
        except Exception:  # noqa: BLE001 - the mirror's read must not cost a step
            return
        if not frame:
            return
        try:
            seq = int(frame.get("policy_seq", 0))
            if seq <= self._policy_seq_seen:
                return
            self._policy_seq_seen = seq
            overrides = {str(k): str(v) for k, v in (frame.get("knob_overrides") or {}).items()
                         if knobs.is_registered(str(k))}
            enforce = self._policy_mode == "enforce" and str(frame.get("mode", "")) == "enforce"
            with self._metrics_lock:
                self._timings["policy_seq"] = float(seq)
                self._timings["policy_applies" if enforce else "policy_intents"] += 1.0
            action = "apply" if enforce else "intent"
            rules = list(frame.get("active_rules", []))
            self._log(logging.INFO, f"policy: {action} seq={seq} overrides={overrides} "
                                    f"rules={rules}")
            emit_event_async(POLICY_EVENTS, replica_id=self._replica_id,
                             group_rank=self._group_rank, step=self._step,
                             quorum_id=self._quorum_id, policy_seq=seq, action=action,
                             overrides=overrides, active_rules=rules)
            _fr.recorder.record("policy_" + action, policy_seq=seq, overrides=overrides,
                                step=self._step, replica=self._replica_id)
            self._tracer.instant("policy_" + action, cat="policy", policy_seq=seq)
            if not enforce:
                return
            previous = self._policy_overrides_applied
            for name in previous:
                if name not in overrides:
                    knobs.set_override(name, None)
                    adjuster = self._policy_adjusters.get(name)
                    if adjuster is not None:
                        adjuster(None)
            for name, value in overrides.items():
                knobs.set_override(name, value)
                adjuster = self._policy_adjusters.get(name)
                if adjuster is not None:
                    adjuster(value)
            # the Manager's own knob: the next streamed allreduce codes with
            # it (error-feedback residuals are kept per plan)
            if "TORCHFT_COMPRESS" in overrides:
                self._compress = resolve_compress_mode(overrides["TORCHFT_COMPRESS"])
            elif "TORCHFT_COMPRESS" in previous:
                self._compress = resolve_compress_mode(None)
            self._policy_overrides_applied = dict(overrides)
        except Exception:  # noqa: BLE001 - the plane is advisory
            logger.exception("policy frame handling failed (ignored)")

    @traced("torchft::manager::_async_quorum")
    def _async_quorum(self, allow_heal: bool, shrink_only: bool, quorum_timeout: float) -> None:
        # the whole control-plane cycle on the quorum thread: with the async
        # quorum, work the step no longer waits for
        t0 = time.perf_counter()
        try:
            self._async_quorum_body(allow_heal, shrink_only, quorum_timeout)
        finally:
            self._record_timing("quorum_overlap_s", time.perf_counter() - t0)

    def _async_quorum_body(
        self, allow_heal: bool, shrink_only: bool, quorum_timeout: float
    ) -> None:
        try:
            with self._tracer.span("quorum_rpc", cat="quorum"):
                quorum = self._client._quorum(
                    group_rank=self._group_rank,
                    step=self._step,
                    checkpoint_metadata=self._checkpoint_transport.metadata(),
                    shrink_only=shrink_only,
                    timeout=quorum_timeout,
                    init_sync=self._init_sync,
                    commit_failures=self._commit_failures,
                )
        except Exception as e:  # noqa: BLE001 - swallowed into the step's vote
            self._log(logging.ERROR, f"quorum RPC failed: {e}")
            self.report_error(e)
            return

        self._num_replicas = quorum.replica_world_size
        self._bump_metric("quorums")
        self._tracer.set_context(quorum_id=quorum.quorum_id, step=self._step)
        # async quorum, or no heal: replicas behind sit this step out, so the
        # participating world is the max-step cohort; the sync quorum heals
        # first, so everyone counts
        if self._use_async_quorum or not allow_heal:
            self._participating_replica_rank = quorum.max_replica_rank
            self._participating_replica_world_size = quorum.max_world_size
        else:
            self._participating_replica_rank = quorum.replica_rank
            self._participating_replica_world_size = quorum.replica_world_size
        if self._replica_world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            # spares past min_replica_size contribute zeros: the gradient's
            # scale stays fixed
            self._participating_replica_world_size = min(
                self._participating_replica_world_size, self._min_replica_size
            )
            if (self._participating_replica_rank is not None
                    and self._participating_replica_rank >= self._min_replica_size):
                self._participating_replica_rank = None

        if quorum.quorum_id != self._quorum_id:
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}/{self._group_rank}"
            )
            self._log(logging.INFO, f"reconfiguring for quorum_id={quorum.quorum_id}")
            log_quorum_event(
                replica_id=self._replica_id,
                group_rank=self._group_rank,
                step=self._step,
                quorum_id=quorum.quorum_id,
                replica_rank=quorum.replica_rank,
                replica_world_size=quorum.replica_world_size,
                heal=quorum.heal,
                recover_dst_replica_ranks=quorum.recover_dst_replica_ranks,
            )
            try:
                self._bump_metric("reconfigures")
                # everything control-plane runs here; a commit that must
                # touch live state runs on the main thread at a safe point
                t_prep = time.perf_counter()
                with trace_span("torchft::manager::_pg::prepare_configure"), \
                        self._tracer.span("configure_prepare", cat="quorum"):
                    pg_commit = self._pg.prepare_configure(
                        store_prefixed_addr,
                        quorum.replica_rank,
                        quorum.replica_world_size,
                        quorum_id=quorum.quorum_id,
                    )
                self._record_timing("configure_prepare_s", time.perf_counter() - t_prep)
                with self._pending_commit_lock:
                    self._pending_pg_commit = pg_commit
                if pg_commit is None:
                    self._record_timing("configure_commit_s", 0.0)
                with trace_span("torchft::manager::_transport::configure"), \
                        self._tracer.span("transport_configure", cat="quorum"):
                    self._checkpoint_transport.configure(
                        f"{quorum.store_address}/torchft/{quorum.quorum_id}"
                        f"/recovery/{self._group_rank}",
                        quorum.replica_rank,
                        quorum.replica_world_size,
                        quorum_id=quorum.quorum_id,
                    )
                # recorded only after both configures succeed: on failure
                # the vote fails, the next quorum carries commit_failures>0
                # and the lighthouse bumps the id for EVERY replica
                self._quorum_id = quorum.quorum_id
                # the flight recorder's reconfigure boundary
                _fr.recorder.record("quorum_reconfigure", quorum_id=quorum.quorum_id,
                                    replica=self._replica_id, group_rank=self._group_rank)
                if pg_commit is None:
                    # a split prepare logs its snapshot once its commit ran
                    self._log_timing_snapshot("configure_prepare")
            except Exception as e:  # noqa: BLE001 - swallowed into the vote
                self._log(logging.ERROR, f"pg configure failed: {e}")
                self.report_error(e)
                return

        if not allow_heal:
            return
        try:
            if quorum.recover_dst_replica_ranks:
                self._log(
                    logging.INFO,
                    f"peers need recovery from us {quorum.recover_dst_replica_ranks}",
                )
                t0 = time.perf_counter()
                with trace_span("torchft::manager::send_checkpoint"), \
                        self._tracer.span("heal_send", cat="heal",
                                          dst_ranks=list(quorum.recover_dst_replica_ranks)):
                    self._checkpoint_transport.send_checkpoint(
                        dst_ranks=quorum.recover_dst_replica_ranks,
                        step=quorum.max_step,
                        state_dict=self._manager_state_dict(),
                        timeout=self._timeout,
                    )
                self._record_timing("heal_send_s", time.perf_counter() - t0)
            # a standby failover source: someone is behind but we got no
            # destination. A healer whose source dies fails over to the
            # quorum's fallback peers, which works only if they staged the
            # step: stage once per heal episode and hold the window open
            # across commits until nobody is behind. Pull-based transports
            # only (a push transport's standby would never be asked).
            standby_wanted = (
                not quorum.recover_dst_replica_ranks
                and quorum.max_world_size < quorum.replica_world_size
                and self._checkpoint_transport.supports_multi_source
            )
            standby = standby_wanted and not quorum.heal
            if standby_wanted and quorum.heal:
                # behind ourselves: our state is the pre-heal copy
                self._log(logging.WARNING,
                          f"refusing to stage a standby snapshot for step {quorum.max_step}: "
                          "this replica is itself healing")
                self._bump_counter("standby_skipped")
            if standby and not self._standby_source:
                self._log(logging.INFO, f"staging a standby snapshot for step {quorum.max_step}")
                t0 = time.perf_counter()
                self._checkpoint_transport.send_checkpoint(
                    dst_ranks=[],
                    step=quorum.max_step,
                    state_dict=self._manager_state_dict(),
                    timeout=self._timeout,
                )
                self._record_timing("standby_send_s", time.perf_counter() - t0)
            self._standby_source = standby
            if quorum.heal:
                self._healing = True
                self._bump_counter("heal_attempts")
                t0 = time.perf_counter()
                with trace_span("torchft::manager::recv_checkpoint"), \
                        self._tracer.span("heal_recv", cat="heal"):
                    self._pending_state_dict = self._recv_checkpoint(quorum)
                self._record_timing("heal_recv_s", time.perf_counter() - t0)
                stream = self._checkpoint_transport.last_recv_timings()
                if stream is not None:
                    self._record_timing("heal_chunks", float(stream.num_chunks))
                    self._record_timing("heal_mb_per_s", stream.mb_per_s)
                # ft step/batches restore now; user state is applied from
                # the main thread when safe
                self.load_state_dict(self._pending_state_dict["torchft"])
                self._step = quorum.max_step
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._log(logging.ERROR, f"recovery failed: {e}")
            self.report_error(e)

    def _heal_sources(self, quorum: Any) -> List[Tuple[str, Callable[[], str]]]:
        """The candidate sources of a multi-peer heal, in order: the
        assigned source, then the other up-to-date peers in the native
        quorum's round-robin order. Each is ``(label, metadata_fn)``, the
        metadata RPC made only if the transport tries that source."""

        def metadata_fn(addr: str) -> Callable[[], str]:
            def fetch() -> str:
                client = ManagerClient(addr, connect_timeout=self._connect_timeout)
                client.set_retry_observer(self._on_rpc_retry)
                return client._checkpoint_metadata(self._group_rank, timeout=self._timeout)

            return fetch

        sources = [(
            f"replica_rank_{quorum.recover_src_replica_rank}"
            f"@{quorum.recover_src_manager_address}",
            metadata_fn(quorum.recover_src_manager_address),
        )]
        for peer in quorum.recover_src_fallbacks:
            sources.append((f"replica_rank_{peer.replica_rank}@{peer.address}",
                            metadata_fn(peer.address)))
        return sources

    def _on_heal_event(self, kind: str, **fields: Any) -> None:
        """The transport's resilient-heal events, counted in timings()."""
        counter = {
            "heal_retry": "heal_attempts",
            "heal_failover": "heal_failovers",
            "chunk_crc_failure": "chunk_crc_failures",
        }.get(kind)
        if counter is not None:
            self._bump_counter(counter)
        self._log(logging.WARNING, f"heal event {kind}: {fields}")
        self._tracer.instant(kind, cat="heal", **fields)
        _fr.recorder.record(kind, step=self._step, replica=self._replica_id,
                            group_rank=self._group_rank, **fields)

    def _recv_checkpoint(self, quorum: Any) -> Dict[str, Any]:
        """Fetch the heal, failing over across up-to-date peers when the
        transport can (pull-based HTTP); a push-based transport stays on
        the assigned source, the only one sending."""
        transport = self._checkpoint_transport
        # with the redundancy plane on, a parallel reconstruct of the
        # quorum's step first; any failure falls back to the pull
        if self._redundancy_cfg is not None and self._redundancy_cfg.enabled:
            state = self._reconstruct_checkpoint(quorum)
            if state is not None:
                return state
        if transport.supports_multi_source:
            sources = self._heal_sources(quorum)
            self._log(logging.INFO, f"healing from step {quorum.max_step}, candidate sources "
                                    f"{[label for label, _ in sources]}")
            try:
                return transport.recv_checkpoint_multi(
                    sources, step=quorum.max_step, timeout=self._timeout,
                    on_event=self._on_heal_event,
                )
            except Exception:
                # every source failed: dump both rings while the heal's
                # retries and failovers are still in them
                fr_path = _fr.recorder.dump(
                    reason="heal_exhausted", quorum_id=quorum.quorum_id,
                    tag=f"{self._replica_id}_{self._group_rank}_s{quorum.max_step}_heal_exhausted")
                self._auto_dump_trace("heal_exhausted", fr_path)
                raise
        self._log(
            logging.INFO,
            f"healing from {quorum.recover_src_manager_address} step {quorum.max_step}",
        )
        client = ManagerClient(
            quorum.recover_src_manager_address, connect_timeout=self._connect_timeout
        )
        client.set_retry_observer(self._on_rpc_retry)
        metadata = client._checkpoint_metadata(self._group_rank, timeout=self._timeout)
        return transport.recv_checkpoint(
            src_rank=quorum.recover_src_replica_rank,
            metadata=metadata,
            step=quorum.max_step,
            timeout=self._timeout,
        )

    def _apply_pending_state_dict(self) -> None:
        self.wait_quorum()
        pending = self._pending_state_dict
        if pending is None:
            raise RuntimeError("checkpoint was not staged")
        self._log(logging.INFO, "applying pending state dict")
        with self._state_dict_lock.w_lock():
            user = pending["user"]
            for key, load_fn in self._load_state_dict_fns.items():
                if key in user:
                    load_fn(user[key])
            self._pending_state_dict = None
        self._last_quorum_healed = True
        self._bump_metric("heals")

    def _commit_pending_configure(self) -> None:
        """Run the main-thread half of a reconfigure, if the last prepare
        left one. A failed commit fails the step and forces the next
        quorum to reconfigure even under the same quorum id."""
        with self._pending_commit_lock:
            commit, self._pending_pg_commit = self._pending_pg_commit, None
        if commit is None:
            return
        t0 = time.perf_counter()
        try:
            with trace_span("torchft::manager::configure_commit"), \
                    self._tracer.span("configure_commit", cat="quorum"):
                commit()
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._quorum_id = -1
            self._log(logging.ERROR, f"pg configure commit failed: {e}")
            self.report_error(e)
        finally:
            self._record_timing("configure_commit_s", time.perf_counter() - t0)
            self._log_timing_snapshot("configure_commit")

    # ------------------------------------------------------------ allreduce
    def allreduce(
        self,
        values: Any,
        should_quantize: bool = False,
        reduce_op: ReduceOp = ReduceOp.AVG,
    ) -> Work:
        """Fault-tolerant allreduce over a pytree of tensors or arrays.

        Returns a Work whose future resolves to the reduced pytree, each leaf
        on its input's device with its input's dtype (dicts keyed in sorted
        order, as the reference's). On error the future resolves to a zeros
        pytree and the error is kept for ``should_commit``."""
        work, _stream = self._allreduce(values, should_quantize, reduce_op)
        return work

    def allreduce_streamed(
        self,
        values: Any,
        reduce_op: ReduceOp = ReduceOp.AVG,
        bucket_cap_bytes: Optional[int] = None,
        should_quantize: bool = False,
    ) -> GradStream:
        """``allreduce`` with per-bucket completion: the GradStream's
        ``ready(i)`` says when bucket i has landed and ``wait()`` returns
        the reduced pytree. ``bucket_cap_bytes`` overrides the Manager's cap
        for this call. A tree that does not stream (single leaf, bucketing
        or streaming off) gives a one-bucket stream."""
        work, stream = self._allreduce(
            values, should_quantize, reduce_op, bucket_cap_bytes=bucket_cap_bytes
        )
        if stream is None:
            fut = work.get_future()
            stream = GradStream([fut], fut)
        return stream

    @traced("torchft::manager::allreduce")
    def _allreduce(
        self,
        values: Any,
        should_quantize: bool = False,
        reduce_op: ReduceOp = ReduceOp.AVG,
        bucket_cap_bytes: Optional[int] = None,
    ) -> Tuple[Work, Optional[GradStream]]:
        """The engine behind allreduce and allreduce_streamed: ``(work,
        stream)``, the stream a GradStream when the op streamed."""
        self._bump_metric("allreduces")
        leaves, treedef = bucketing.tree_flatten(values)
        cap = self._bucket_cap_bytes if bucket_cap_bytes is None else int(bucket_cap_bytes)
        # the serial quantized path is never pre-bucketed: it flattens the
        # tree into one wire itself, and packing first would move its fp8
        # row boundaries; streamed, a quantized tree rides compressed buckets
        plan: Optional[bucketing.BucketPlan] = None
        if (not should_quantize or self._stream_buckets) and len(leaves) > 1 and cap > 0:
            try:
                plan = bucketing.plan_for(leaves, cap, treedef=treedef)
            except Exception:  # noqa: BLE001 - exotic leaves go unbucketed
                plan = None

        def rebuild(reduced: List[Any]) -> Any:
            return pytree.tree_unflatten(
                [_place(o, r) for o, r in zip(leaves, reduced)], treedef
            )

        def zeros() -> Any:
            return pytree.tree_unflatten([_zeros_like(l) for l in leaves], treedef)

        if self.errored():
            return DummyWork(zeros()), None
        self.wait_quorum()
        # a reconfigure that landed during the forward pass commits here,
        # before the collective touches the process group
        self._commit_pending_configure()
        if self.errored():
            return DummyWork(zeros()), None
        num_participants = self.num_participants()

        pg_reduce_op = reduce_op
        if reduce_op == ReduceOp.AVG:
            if not all(_is_float_leaf(l) for l in leaves):
                raise ValueError("AVG allreduce requires floating point leaves")
            pg_reduce_op = ReduceOp.SUM

        def divide(x: Any) -> Any:
            if reduce_op == ReduceOp.AVG and num_participants > 0:
                return true_divide(x, num_participants)
            return x

        try:
            if plan is not None and self._stream_buckets:
                return self._allreduce_streaming(
                    leaves, treedef, plan, should_quantize, pg_reduce_op, divide, zeros
                )
            return FutureWork(self._allreduce_serial(
                leaves, plan, should_quantize, pg_reduce_op, divide, rebuild, zeros
            )), None
        except Exception as e:  # noqa: BLE001 - swallowed into the vote
            self._log(logging.ERROR, f"allreduce failed: {e}")
            self.report_error(e)
            return DummyWork(zeros()), None

    def _allreduce_serial(
        self,
        leaves: List[Any],
        plan: Optional[bucketing.BucketPlan],
        should_quantize: bool,
        pg_reduce_op: ReduceOp,
        divide: Callable[[Any], Any],
        rebuild: Callable[[List[Any]], Any],
        zeros: Callable[[], Any],
    ) -> Future:
        """One collective for the whole tree (its buckets, when ``plan``)
        on the ordered staging worker."""
        # capture on the caller thread: the staging thread reads these
        # after allreduce() returns, when the caller may already be
        # mutating its gradients. Non-participants contribute zeros.
        if plan is not None:
            if self.is_participating():
                capture, _pooled = bucketing.pack(leaves, plan)
            else:
                capture = [
                    torch.zeros(size, dtype=dtype, device=_leaf_device(leaves[g[0]]))
                    for g, size, dtype in zip(plan.groups, plan.sizes, plan.dtypes)
                ]
        elif self.is_participating():
            capture = [
                l.detach().clone() if isinstance(l, torch.Tensor) else np.array(l, copy=True)
                for l in leaves
            ]
        else:
            capture = [_zeros_like(l) for l in leaves]
        staged_fut: Future = Future()
        stage_timeout = self._timeout

        def _stage_deadline() -> None:
            try:
                staged_fut.set_exception(TimeoutError("allreduce staging timed out"))
            except RuntimeError:
                pass

        def stage() -> None:
            # the deadline spans the whole staged op, wire included, and
            # starts when staging begins (not at submission)
            cancel = arm_deadline(_stage_deadline, stage_timeout)
            staged_fut.add_done_callback(lambda _f: cancel())
            try:
                if should_quantize:
                    from torchft_tpu_torch.collectives import allreduce_quantized

                    w = allreduce_quantized(capture, pg_reduce_op, self._pg)
                    staged_fut.set_result(w.get_future().wait(stage_timeout))
                    return
                w = self._pg.allreduce(capture, pg_reduce_op)

                def _xfer(f: Future) -> None:
                    try:
                        exc = f.exception()
                        if exc is not None:
                            staged_fut.set_exception(exc)
                        else:
                            staged_fut.set_result(f.value())
                    except RuntimeError:
                        pass

                w.get_future().add_done_callback(_xfer)
            except Exception as e:  # noqa: BLE001 - resolves the op
                try:
                    staged_fut.set_exception(e)
                except RuntimeError:
                    pass

        def normalize(f: Future) -> Any:
            reduced = [divide(r) for r in f.value()]
            if plan is not None:
                reduced = bucketing.unpack(reduced, plan)
            return rebuild(reduced)

        self._staging_executor.submit(stage)
        return self.wrap_future(staged_fut.then(normalize), zeros)

    def _allreduce_streaming(
        self,
        leaves: List[Any],
        treedef: Any,
        plan: bucketing.BucketPlan,
        should_quantize: bool,
        pg_reduce_op: ReduceOp,
        divide: Callable[[Any], Any],
        zeros: Callable[[], Any],
    ) -> Tuple[Work, GradStream]:
        """One collective per bucket, three stages each: pack (on the
        staging worker: the coding with error feedback, or the staging of
        the raw bucket), wire (the PG's dispatch thread), unpack (decode,
        divide, slice and land one bucket, on the unpack worker). Numerics
        are the serial path's per bucket."""
        n_buckets = len(plan)
        # per-bucket (start, end) perf_counter marks of each stage
        marks: List[Dict[str, Tuple[float, float]]] = [{} for _ in range(n_buckets)]
        bucket_futs: List[Future] = [Future() for _ in range(n_buckets)]
        devices = [_leaf_device(leaves[g[0]]) for g in plan.groups]
        final_fut: Future = Future()

        def _assemble(f: Future) -> Any:
            placed: Dict[int, Any] = {}
            for pairs in f.value():
                placed.update(pairs)
            return pytree.tree_unflatten([placed[i] for i in range(len(leaves))], treedef)

        def _feed_final(f: Future) -> None:
            try:
                value = f.value()
            except Exception as e:  # noqa: BLE001 - the join's failure
                try:
                    final_fut.set_exception(e)
                except RuntimeError:
                    pass
                return
            try:
                final_fut.set_result(value)
            except RuntimeError:  # the staging deadline fired first
                pass

        joined = join_futures(bucket_futs)
        # timings land before the result: a caller reads them after wait().
        # After a failure other buckets may still be adding marks: copies
        # (one C call each under the GIL) keep the reading safe.
        joined.add_done_callback(
            lambda _f: self._record_pipeline_timings([dict(m) for m in marks])
        )
        joined.then(_assemble).add_done_callback(_feed_final)

        def _land_bucket(i: int, flat: Any, pooled_buf: Optional[torch.Tensor]) -> None:
            try:
                t0 = time.perf_counter()
                if is_compressed_wire(flat):
                    # the codes carry the reduced SUM, decoded to the
                    # bucket's dtype before the divide, as the reference's
                    flat = decompress_bucket(flat)
                elif not isinstance(flat, torch.Tensor):
                    flat = torch.from_numpy(flat)
                flat = divide(flat.to(devices[i]))
                pairs = [
                    (idx, _place(leaves[idx], val))
                    for idx, val in bucketing.unpack_bucket(flat, plan, i)
                ]
                if devices[i].type == "cuda":
                    # the landed tensors are ready on any stream the caller
                    # reads them from
                    torch.cuda.current_stream(devices[i]).synchronize()
                marks[i]["unpack"] = (t0, time.perf_counter())
                if pooled_buf is not None:
                    self._buffer_pool.release(pooled_buf)
                bucket_futs[i].set_result(pairs)
            except Exception as e:  # noqa: BLE001 - fails the join
                try:
                    bucket_futs[i].set_exception(e)
                except RuntimeError:
                    pass

        participating = self.is_participating()
        if participating:
            capture, pooled = bucketing.pack(leaves, plan, pool=self._buffer_pool)
        else:
            capture, pooled = None, []
        pooled_ids = {id(b) for b in pooled}
        # the packs ran on the caller's stream; the staging worker's launches
        # and copies wait for them there
        packed = {}
        for dev in set(devices):
            if dev.type == "cuda":
                packed[dev] = torch.cuda.Event()
                packed[dev].record(torch.cuda.current_stream(dev))

        compress_mode = self._compress
        if should_quantize and compress_mode == "off":
            compress_mode = "fp8"
        bucket_modes = [
            compress_mode if dtype.is_floating_point else "off" for dtype in plan.dtypes
        ]
        # non-participants code their zero contribution too (the ring needs
        # the same wire geometry everywhere) but never touch the residuals
        ef_store = (
            self._bucket_residuals(plan)
            if participating and compress_mode != "off" else None
        )
        stage_timeout = self._timeout

        def _stage_deadline() -> None:
            try:
                final_fut.set_exception(TimeoutError("allreduce staging timed out"))
            except RuntimeError:
                pass

        def _wire_done(f: Future, i: int, t0w: float, pooled_buf: Any) -> None:
            # on the PG's dispatch thread: record and hand off at once
            marks[i]["wire"] = (t0w, time.perf_counter())
            try:
                flat = f.value()[0]
                self._unpack_executor.submit(_land_bucket, i, flat, pooled_buf)
            except Exception as e:  # noqa: BLE001 - the wire's or shutdown's
                try:
                    bucket_futs[i].set_exception(e)
                except RuntimeError:
                    pass

        def stage() -> None:
            cancel = arm_deadline(_stage_deadline, stage_timeout)
            final_fut.add_done_callback(lambda _f: cancel())
            try:
                for dev, ev in packed.items():
                    torch.cuda.current_stream(dev).wait_event(ev)
                for i in range(n_buckets):
                    t0 = time.perf_counter()
                    if capture is None:
                        flat = torch.zeros(plan.sizes[i], dtype=plan.dtypes[i], device=devices[i])
                        pooled_buf = None
                    else:
                        flat = capture[i]
                        pooled_buf = flat if id(flat) in pooled_ids else None
                    payload: Any = flat
                    if bucket_modes[i] != "off":
                        # coded inside the pack stage, so pack_s holds it
                        payload = self._compress_bucket_ef(
                            flat, bucket_modes[i], plan.dtypes[i], ef_store, i
                        )
                    w = self._pg.allreduce([payload], pg_reduce_op)
                    t1 = time.perf_counter()
                    marks[i]["pack"] = (t0, t1)
                    w.get_future().add_done_callback(
                        lambda f, i=i, t1=t1, pb=pooled_buf: _wire_done(f, i, t1, pb)
                    )
            except Exception as e:  # noqa: BLE001 - fails every bucket
                for bf in bucket_futs:
                    try:
                        bf.set_exception(e)
                    except RuntimeError:
                        pass

        self._staging_executor.submit(stage)
        wrapped = self.wrap_future(final_fut, zeros)
        return FutureWork(wrapped), GradStream(bucket_futs, wrapped)

    def _bucket_residuals(self, plan: bucketing.BucketPlan) -> List[Any]:
        """The per-bucket error-feedback residual slots of one plan (None
        until the bucket is first coded)."""
        with self._ef_lock:
            store = self._ef_residuals.get(plan)
            if store is None:
                store = [None] * len(plan)
                self._ef_residuals[plan] = store
            return store

    def _compress_bucket_ef(
        self,
        flat: torch.Tensor,
        mode: str,
        out_dtype: torch.dtype,
        store: Optional[List[Any]],
        i: int,
    ) -> Any:
        """Code one packed bucket for the wire with error feedback: the
        residual (what the coding rounded away at the last step) is added
        in f32 before coding, and replaced by this step's. ``store`` is None
        for a non-participant. On the staging worker only, so a plan's
        residuals never race. A CUDA bucket stays on the card: the add, the
        coding and the residual update run there."""
        resid = store[i] if store is not None else None
        work = flat + resid if resid is not None else flat.to(torch.float32)
        if store is not None and resid is None:
            resid = self._buffer_pool.acquire(work.numel(), torch.float32, work.device)
            store[i] = resid
        return compress_bucket(work, mode, dtype=out_dtype, residual=resid)

    def _on_collective_reroute(self, pair: tuple, attempt: int) -> None:
        """The compressed ring re-formed around a dead link mid-collective:
        a re-routed slow step, counted in timings()["collective_reroute"]."""
        self._bump_counter("collective_reroute")
        self._tracer.instant("reroute", cat="rpc", link=list(pair), attempt=attempt)
        self._log(logging.WARNING, f"collective re-routed around dead link {pair} (attempt {attempt})")
        _fr.recorder.record("collective_reroute", link=tuple(pair), attempt=attempt,
                            step=self._step, replica=self._replica_id, group_rank=self._group_rank)

    def _on_rpc_retry(self, method: str, attempt: int, exc: BaseException) -> None:
        """A control-plane RPC retried: a blip shorter than its timeout is a
        slower step, counted in timings()["rpc_retries"]."""
        self._bump_counter("rpc_retries")
        self._tracer.instant("rpc_retry", cat="rpc", method=method, attempt=attempt)
        self._log(logging.WARNING, f"RPC {method} retrying (attempt {attempt}) after {exc!r}")
        _fr.recorder.record("rpc_retry", method=method, attempt=attempt, error=repr(exc),
                            step=self._step, replica=self._replica_id, group_rank=self._group_rank)

    def _record_pipeline_timings(self, marks: List[Dict[str, Tuple[float, float]]]) -> None:
        """Fold one streamed allreduce's stage marks into timings(), each
        bucket's pack, wire and unpack into the span ring, and emit the
        ``allreduce_pipeline`` snapshot."""
        stats = _pipeline_overlap_stats(marks)
        with self._metrics_lock:
            self._timings.update(stats)
        for i, mark in enumerate(marks):
            for stage in ("pack", "wire", "unpack"):
                if stage in mark:
                    t0_pc, t1_pc = mark[stage]
                    self._tracer.record_rel(stage, cat="allreduce", t0_pc=t0_pc, t1_pc=t1_pc,
                                            bucket=i)
        self._log_timing_snapshot(ALLREDUCE_PIPELINE_PHASE)

    # ------------------------------------------------------------- errors
    def report_error(self, e: Exception) -> None:
        """Mark the step as corrupt: it is discarded at should_commit and
        the PG reconfigured at the next quorum."""
        with self._metrics_lock:
            if self._errored is None:
                self._metrics["errors"] += 1
            self._errored = ExceptionWithTraceback(e)
        _fr.recorder.record("manager_error", error=str(e), step=self._step,
                            replica=self._replica_id, group_rank=self._group_rank)
        _fr.recorder.dump(reason="manager_error", quorum_id=self._quorum_id,
                          tag=f"{self._replica_id}_{self._group_rank}_s{self._step}_manager_error")
        log_error_event(replica_id=self._replica_id, group_rank=self._group_rank,
                        step=self._step, quorum_id=self._quorum_id, error=str(e))

    def errored(self) -> Optional[ExceptionWithTraceback]:
        return self._errored

    def wrap_future(self, fut: Future, default: Any) -> Future:
        """Swallow errors of ``fut`` into ``default`` (a value, or a zero-arg
        factory called only on the error path), reporting them. The
        deadline is the caller's (the allreduce arms one when staging
        begins)."""

        def callback(f: Future) -> Any:
            try:
                return f.value()
            except Exception as e:  # noqa: BLE001 - the swallow contract
                self._log(logging.ERROR, f"future failed, step will be discarded: {e}")
                self.report_error(e)
                return default() if callable(default) else default

        return fut.then(callback)

    # ------------------------------------------------------------- commit
    @traced("torchft::manager::should_commit")
    def should_commit(self, timeout: "float | timedelta | None" = None) -> bool:
        """Two-phase commit vote across the replica group: True iff every
        rank of this group is healthy and enough replicas participate.
        ``timeout`` bounds the vote's RPC (default the Manager's timeout).
        Raises once the vote failed more than ``max_retries`` times in a
        row. The group leader then hands the step's telemetry to its
        heartbeat (``_publish_step_telemetry``)."""
        t_begin = time.perf_counter()
        if self._quorum_future is not None:
            try:
                self._quorum_future.result()
            except Exception as e:  # noqa: BLE001 - swallowed into the vote
                self.report_error(e)
        # waiting for the quorum thread is overlap lost, not bookkeeping
        join_s = time.perf_counter() - t_begin
        # the commit lands before pg.errored() is read: the old world may be
        # errored by the fault that changed the membership
        self._commit_pending_configure()
        if (err := self._pg.errored()) is not None:
            self.report_error(err)
        if self._healing and self._pending_state_dict is not None:
            self._apply_pending_state_dict()
        self._healing = False

        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self._errored is None
        if not local_should_commit:
            self._log(
                logging.WARNING,
                f"voting False: participants={self.num_participants()} "
                f"min={self._min_replica_size} errored={self._errored!r}",
            )
        t_rpc = time.perf_counter()
        with self._tracer.span("commit_vote", cat="commit", local=local_should_commit):
            should_commit = self._vote_client.should_commit(
                self._group_rank,
                self._step,
                local_should_commit,
                timeout=_to_seconds(timeout) if timeout is not None else self._timeout,
            )
        rpc_s = time.perf_counter() - t_rpc
        emit_event_async(
            COMMIT_EVENTS,
            replica_id=self._replica_id,
            group_rank=self._group_rank,
            step=self._step,
            quorum_id=self._quorum_id,
            committed=should_commit,
            enough_replicas=enough_replicas,
            errored=self._errored is not None,
            num_participants=self.num_participants(),
        )
        if not self._standby_source:
            self._checkpoint_transport.disallow_checkpoint()
        if should_commit:
            if self._serve_publisher is not None:
                # before the step advances: the version is stamped with the
                # step that voted (reference :3289-3292)
                self._serve_publish_committed()
            if self._shard_stager is not None:
                # staged at the next round's start, labelled with the step
                # a healer joining it needs, once the caller applied this
                # round's update (reference :3293-3302)
                self._redundancy_stage_pending = True
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            self._bump_metric("commits")
        else:
            self._commit_failures += 1
            self._bump_metric("commit_failures")
            if self._max_retries is not None and self._commit_failures > self._max_retries:
                msg = (f"should_commit failed {self._commit_failures} times consecutively, "
                       f"exceeding max_retries={self._max_retries}")
                self._log(logging.ERROR, msg)
                raise RuntimeError(msg)
        self._record_timing("should_commit_rpc_s", rpc_s)
        self._record_timing("bookkeeping_s",
                            max(0.0, time.perf_counter() - t_begin - rpc_s - join_s))
        # no RPC here: a dict for the heartbeat thread, the last summary back
        self._publish_step_telemetry(committed=should_commit)
        return should_commit

    # -------------------------------------------------------- introspection
    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def _manager_state_dict(self) -> Dict[str, Any]:
        if not self._user_state_dicts:
            raise RuntimeError("user state_dict is not registered")
        return {"user": self.user_state_dict(), "torchft": self.state_dict()}

    def state_dict_template(self) -> Dict[str, Any]:
        """The live heal composite, as an in-place template for a transport:
        ``PGTransport(pg, state_dict_template=lambda:
        manager.state_dict_template())`` (late-bound: the transport is made
        before the Manager). Sender and receiver build this tree from their
        registered state fns, so its leaves align by index."""
        return self._manager_state_dict()

    # ------------------------------------------------------ serving plane
    def attach_serve_publisher(self, publisher: Any,
                               params_fn: Optional[Callable[[], Any]] = None) -> None:
        """Attach a serving-plane ``SnapshotPublisher``: every committed
        step is published as a snapshot stamped ``(quorum_id, step)``.
        ``params_fn`` selects what to publish (default: the registered user
        state dict). Group leader only: other ranks ignore the attach, so a
        replica announces once. Advisory: a failed publish is logged and
        counted (``serve_publish_errors_total``), never a failed commit."""
        if self._group_rank != 0:
            return
        self._serve_publisher = publisher
        self._serve_params_fn = params_fn if params_fn is not None else self.user_state_dict

    def _serve_publish_committed(self) -> None:
        """Commit-path hook: hand the just-committed parameters to the
        publisher, whose ``publish_async`` copies them (on the card: on the
        training stream, before the optimizer's next write) and returns;
        encoding and announcing run on its thread. Never raises."""
        t0 = time.perf_counter()
        try:
            self._serve_publisher.publish_async(self._quorum_id, self._step,
                                                self._serve_params_fn())
            self._bump_counter("serve_published_total")
        except Exception:  # noqa: BLE001 - the advisory plane
            self._bump_counter("serve_publish_errors_total")
            logger.exception("serve snapshot publish failed")
        self._record_timing("serve_publish_s", time.perf_counter() - t0)

    def user_state_dict(self) -> Dict[str, Any]:
        with self._state_dict_lock.r_lock():
            return {key: fn() for key, fn in self._user_state_dicts.items()}

    def load_user_state_dict(self, user_state: Dict[str, Any]) -> None:
        """Feed a ``user_state_dict()`` composite back through every
        registered load fn (a cold restart's counterpart of a heal)."""
        with self._state_dict_lock.w_lock():
            for key, load_fn in self._load_state_dict_fns.items():
                if key in user_state:
                    load_fn(user_state[key])

    def current_quorum_id(self) -> int:
        """The id of the last quorum joined (-1 before the first): it moves
        exactly when the membership changes or after commit failures."""
        return self._quorum_id

    def current_step(self) -> int:
        return self._step

    @property
    def store_addr(self) -> str:
        """The replica group's rendezvous store (its leader's), which the
        other group ranks take as ``store_addr``."""
        return self._store_addr

    def batches_committed(self) -> int:
        return self._batches_committed

    def participating_rank(self) -> Optional[int]:
        if self._quorum_future is None:
            return None
        self.wait_quorum()
        return self._participating_replica_rank

    def replica_rank(self) -> Optional[int]:
        return self.participating_rank()

    def num_participants(self) -> int:
        if self._quorum_future is None:
            return 0
        self.wait_quorum()
        return self._participating_replica_world_size

    def num_replicas(self) -> int:
        """Replicas in the current quorum, non-participants included."""
        return self._num_replicas

    def is_participating(self) -> bool:
        if self._participating_replica_rank is None:
            return False
        if self._healing:
            # start_quorum never leaves a sync-quorum replica healing
            assert self._use_async_quorum
            return False
        return True

    def last_quorum_healed(self) -> bool:
        """True iff the most recent quorum live-healed this replica."""
        return self._last_quorum_healed

    def _bump_metric(self, name: str) -> None:
        with self._metrics_lock:
            self._metrics[name] += 1

    def _bump_counter(self, name: str, n: float = 1.0) -> None:
        """Add to a cumulative resilience counter of timings()."""
        with self._metrics_lock:
            self._timings[name] = self._timings.get(name, 0.0) + n

    def metrics(self) -> Dict[str, int]:
        """Lifetime counters: quorums, reconfigures, heals, commits,
        commit_failures, allreduces, errors."""
        with self._metrics_lock:
            return dict(self._metrics)

    def _record_timing(self, name: str, value: float) -> None:
        with self._metrics_lock:
            self._timings[name] = value
        # a phase's histogram fills here, where each value is recorded once
        if self._metrics_registry is not None and name.endswith("_s"):
            self._metrics_registry.observe(f"torchft_manager_{name[:-2]}_seconds", value,
                                           f"Manager {name[:-2]} phase wall-clock (seconds).")

    def timings(self) -> Dict[str, float]:
        """Wall-clock seconds of the last quorum cycle on the quorum thread
        (``quorum_overlap_s``) and of its reconfigure's halves
        (``configure_prepare_s``, ``configure_commit_s``), of the last heal
        send/receive (``heal_send_s``, ``heal_recv_s``) and of the last
        standby snapshot's staging (``standby_send_s``), the chunks and
        MiB/s of the last streamed receive (``heal_chunks``,
        ``heal_mb_per_s``) and,
        once an allreduce has streamed, of its stages summed over buckets
        (``allreduce_pack_s``, ``allreduce_wire_s``, ``allreduce_unpack_s``),
        the wall time some bucket was on the wire (``allreduce_wire_wall_s``),
        its bucket count (``allreduce_buckets``) and ``overlap_efficiency``:
        the share of wire time that ran while another bucket was in some
        stage. Also lifetime counts: compressed-ring re-routes
        (``collective_reroute``), retried RPCs (``rpc_retries``), heal
        attempts and same-source chunk retries (``heal_attempts``),
        failovers to another source (``heal_failovers``), chunks fetched
        again after a crc32 mismatch (``chunk_crc_failures``) and refused
        standby snapshots (``standby_skipped``). With the redundancy plane
        on: this round's staging hot path (``shard_stage_hot_s``, absent
        on a round that staged nothing), the stager's and the last
        reconstruct's seconds, and the plane's counters (``_COUNTERS``).
        With a serve publisher attached: the commit path's hand-off of the
        last committed step (``serve_publish_s``) and the counts
        ``serve_published_total`` / ``serve_publish_errors_total``.

        The health plane (group leader, lighthouse health not ``off``): the
        lighthouse's latest summary of this replica, ``health_state`` (0 ok,
        1 warn, 2 ejected, 3 probation, 4 degraded), ``straggler_score`` and
        the cumulative ``ejections`` / ``readmissions``, 0 until a beat
        brings one. The commit's ``should_commit_rpc_s`` and
        ``bookkeeping_s``. With a pod aggregator configured
        (``TORCHFT_LIGHTHOUSE_AGGREGATOR``, group leader): ``via_aggregator``
        (1 while the control RPCs go through it, 0 after a failover to the
        lighthouse) and the manager server's cumulative
        ``aggregator_failovers``. The observability planes' losses:
        ``dropped_events`` (events the drain shed) and ``trace_dropped``
        (spans the ring overwrote); nonzero means the records are
        incomplete, and the first time says so in a warning."""
        with self._metrics_lock:
            out = dict(self._timings)
        server = getattr(self, "_manager", None)  # None on a shell built by __new__
        if server is not None:
            cs = server.control_status()
            if cs.get("aggregator_addr"):
                out["via_aggregator"] = 1.0 if cs.get("via_aggregator") else 0.0
                out["aggregator_failovers"] = float(cs.get("failovers", 0))
        out["dropped_events"] = float(get_event_drain().dropped)
        out["trace_dropped"] = self._tracer.stats()["dropped"]
        if out["dropped_events"] + out["trace_dropped"] > 0 and not self._dropped_events_warned:
            self._dropped_events_warned = True
            self._log(logging.WARNING,
                      f"observability queues saturated: {int(out['dropped_events'])} telemetry "
                      f"event(s) and {int(out['trace_dropped'])} span(s) dropped so far; "
                      f"timings and trace records are incomplete (raise {TRACE_BUFFER_ENV} or "
                      "scrape and step less often)")
        return out

    # -------------------------------------------------------------- tracing
    @property
    def tracer(self) -> SpanRecorder:
        """This replica's span recorder (``tracing.py``)."""
        return self._tracer

    def dump_trace(self, path: "str | os.PathLike | None" = None) -> Optional[Any]:
        """Write the span ring as a dump ready to merge and return its path
        (None with no destination: pass a path or set
        ``TORCHFT_TRACE_DIR``). Merge one a replica with ``python -m
        torchft_tpu_torch.trace merge``."""
        return self._tracer.dump(path)

    def _auto_dump_trace(self, reason: str, fr_path: Optional[Any]) -> None:
        """The span ring beside a flight-recorder dump (same directory, the
        reason in its name), or at the default destination when that dump
        was off. Never raises."""
        try:
            path = None
            if fr_path is not None:
                path = os.path.join(
                    os.path.dirname(fr_path),
                    f"trace_{self._replica_id}_{self._group_rank}_s{self._step}_{reason}.json")
            out = self._tracer.dump(path)
            if out is not None:
                self._log(logging.WARNING, f"span ring dumped to {out} ({reason})")
        except Exception:  # noqa: BLE001 - a postmortem path never raises
            logger.exception("trace auto-dump failed")

    @property
    def metrics_port(self) -> Optional[int]:
        """The bound port of ``/metrics`` (None when not serving)."""
        return self._metrics_server.port if self._metrics_server is not None else None

    def _refresh_metrics(self) -> None:
        """At a scrape: timings() and metrics() into the registry, counters
        as ``_total`` (absolute, so a scrape never counts twice), the rest
        as last-value gauges, with the step, the quorum id, the spans
        recorded, the wire's counters and the clock skew."""
        reg = self._metrics_registry
        if reg is None:
            return
        for name, value in self.timings().items():
            if name in _COUNTER_TIMINGS:
                total = name if name.endswith("_total") else f"{name}_total"
                reg.counter_set(f"torchft_manager_{total}", float(value),
                                f"Cumulative {name} (Manager.timings()).")
            else:
                reg.gauge_set(f"torchft_manager_{name}", float(value),
                              f"Last-value {name} (Manager.timings()).")
        for name, value in self.metrics().items():
            reg.counter_set(f"torchft_manager_{name}_total", float(value),
                            f"Lifetime {name} (Manager.metrics()).")
        reg.gauge_set("torchft_manager_step", float(self._step), "Current manager step.")
        reg.gauge_set("torchft_manager_quorum_id", float(self._quorum_id),
                      "Quorum id of the current process-group generation.")
        reg.counter_set("torchft_manager_trace_spans_total", self._tracer.stats()["recorded"],
                        "Spans recorded into the trace ring since construction.")
        try:
            wire_fn = getattr(self._pg, "wire_stats", None)
            wire = wire_fn() if wire_fn is not None else {}
        except Exception:  # noqa: BLE001 - a scrape shows what it can
            wire = {}
        for name, value in wire.items():
            if name.startswith("bytes_"):
                reg.counter_set(f"torchft_manager_wire_{name}_total", float(value),
                                f"Cumulative transport {name} across PG generations.")
            else:
                reg.gauge_set(f"torchft_manager_wire_{name}", float(value),
                              f"Transport {name} (ProcessGroup.wire_stats()).")
        skew = self._manager.clock_skew() if self._manager is not None else {}
        if skew:
            reg.gauge_set("torchft_manager_clock_skew_ms", float(skew.get("skew_ms", 0.0)),
                          "Estimated clock skew vs the lighthouse "
                          "(best = minimum-RTT heartbeat sample).")
            reg.gauge_set("torchft_manager_clock_skew_rtt_ms", float(skew.get("rtt_ms", 0.0)),
                          "Heartbeat RTT of the best skew sample.")

    def _log_timing_snapshot(self, phase: str) -> None:
        """A ``torchft_timings`` snapshot of timings() through the async
        drain (it fires on the commit path)."""
        try:
            emit_event_async(TIMING_EVENTS, replica_id=self._replica_id,
                             group_rank=self._group_rank, step=self._step,
                             quorum_id=self._quorum_id, phase=phase, **self.timings())
        except Exception:  # noqa: BLE001 - observability never fails a step
            logger.exception("failed to log timing snapshot")

    # ---------------------------------------------------------- healthwatch
    def set_telemetry_transform(
        self, fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]]
    ) -> None:
        """A hook applied to each step's telemetry just before it is
        published (None clears it): tests dilate the reported ``step_s`` to
        make a straggler without slowing a replica."""
        self._telemetry_transform = fn

    def health(self) -> Dict[str, Any]:
        """The lighthouse's latest health summary of this replica, as the
        last heartbeat brought it (``state``, ``state_code``, ``score``,
        ``ejections``, ``readmissions``): fresher than ``timings()``, which
        folds it in at each vote. ``{}`` before the first beat returned and
        on a rank other than the group's leader."""
        return self._manager.health() if self._manager is not None else {}

    def _publish_step_telemetry(self, committed: bool = True) -> None:
        """Group leader: stage this step's telemetry for the heartbeat
        thread (the lighthouse's ledger ingests it) and fold the summary
        the last beat brought back into timings() and ``torchft_health``.

        ``step_s`` is the time between consecutive votes, the one boundary
        every replica crosses once a step; ``wire_s`` the last allreduce's
        wire seconds, so the ledger scores compute (step less wire: the
        allreduce is a barrier, so wall time is equal across the quorum).
        A sample is published only when this vote and the last both
        committed under the same quorum id: an interval over a failed vote,
        a heal or a reconfigure (an ejected replica's first interval after
        readmission spans the whole exclusion) is not training pace. Never
        raises: telemetry is advisory and this is the commit path."""
        self._tracer.set_context(step=self._step)
        if self._manager is None:
            return
        try:
            skew = self._manager.clock_skew()
            self._tracer.set_skew(skew.get("skew_ms", 0.0), skew.get("rtt_ms", 0.0),
                                  skew.get("samples", 0))
        except Exception:  # noqa: BLE001 - advisory, on the commit path
            pass
        now = time.perf_counter()
        last, self._last_commit_t = self._last_commit_t, now
        prev_committed, self._last_vote_committed = self._last_vote_committed, committed
        same_quorum = self._quorum_id == self._telemetry_quorum_id
        self._telemetry_quorum_id = self._quorum_id
        try:
            if last is not None and committed and prev_committed and same_quorum:
                with self._metrics_lock:
                    t = self._timings
                    telemetry: Dict[str, Any] = {
                        "step": self._step,
                        "step_s": now - last,
                        # the wire's wall time: the buckets' summed intervals
                        # overlap (_pipeline_overlap_stats)
                        "wire_s": t.get("allreduce_wire_wall_s", 0.0),
                        "heal_attempts": t["heal_attempts"],
                        "rpc_retries": t["rpc_retries"],
                        # cumulative link-fault counters, per replica
                        "collective_reroute": t["collective_reroute"],
                        "chunk_crc_failures": t["chunk_crc_failures"],
                    }
                if self._telemetry_transform is not None:
                    telemetry = self._telemetry_transform(telemetry)
                self._manager.publish_telemetry(telemetry)
            self._observe_health(self._manager.health())
        except Exception:  # noqa: BLE001 - advisory, on the commit path
            logger.exception("failed to publish step telemetry")

    def _observe_health(self, summary: Dict[str, Any]) -> None:
        """A heartbeat's health summary into timings(); on each change of
        state a ``torchft_health`` event, a flight-recorder breadcrumb and a
        span instant (``straggler_warn``, ``eject``, ``readmit``,
        ``recovered``); on an ejection both rings are dumped."""
        state = summary.get("state")
        if not state:
            return
        score = summary.get("score", 0.0)
        with self._metrics_lock:
            self._timings["health_state"] = float(summary.get("state_code", 0))
            self._timings["straggler_score"] = float(score)
            self._timings["ejections"] = float(summary.get("ejections", 0))
            self._timings["readmissions"] = float(summary.get("readmissions", 0))
        prev, self._last_health_state = self._last_health_state, state
        if prev == state or prev is None and state == "ok":
            return
        kind = _HEALTH_TRANSITIONS.get(state, state)
        emit_event_async(HEALTH_EVENTS, replica_id=self._replica_id, group_rank=self._group_rank,
                         step=self._step, quorum_id=self._quorum_id, kind=kind, state=state,
                         prev_state=prev, score=score, ejections=summary.get("ejections", 0),
                         readmissions=summary.get("readmissions", 0))
        self._log(logging.WARNING, f"healthwatch: {kind} (state {prev} -> {state}, score={score})")
        _fr.recorder.record(kind, state=state, prev_state=prev, score=score, step=self._step,
                            replica=self._replica_id, group_rank=self._group_rank)
        self._tracer.instant(kind, cat="health", state=state, prev_state=prev, score=score)
        if kind == "eject":
            # out of the quorum: dump while the straggler's evidence is in
            # the rings
            fr_path = _fr.recorder.dump(
                reason="eject", quorum_id=self._quorum_id,
                tag=f"{self._replica_id}_{self._group_rank}_s{self._step}_eject")
            self._auto_dump_trace("eject", fr_path)

    # ------------------------------------------------------ redundancy plane
    def _on_redundancy_metric(self, name: str, value: float) -> None:
        """ShardStager / HotSpare -> timings(): a counter of ``_COUNTERS``
        adds up, any other name is a last-value timing."""
        if name in _COUNTERS:
            self._bump_counter(name, value)
        else:
            self._record_timing(name, value)

    def _on_redundancy_event(self, kind: str, info: Dict[str, Any]) -> None:
        """reconstruct_state -> the per-shard fault counters and span
        instants."""
        if kind in ("shard_corrupt", "shard_fetch_failed"):
            self._bump_counter(kind)
            self._log(logging.WARNING, f"redundancy event {kind}: {info}")
        self._tracer.instant(kind, cat="redundancy", **info)

    def _reconstruct_checkpoint(self, quorum: Any) -> Optional[Dict[str, Any]]:
        """The parallel shard reconstruct of the quorum's step, landed in
        place in ``state_dict_template()``; None to fall back to the peer
        pull (it never raises: the plane speeds a heal up, the heal does
        not depend on it). ``reconstruct_state`` raises, before it lands
        anything, when no live owner announced that step."""
        try:
            with self._tracer.span("reconstruct", cat="redundancy", step=quorum.max_step):
                step, state, stats = reconstruct_state(
                    self._redundancy_cfg.directory, step=quorum.max_step, timeout=self._timeout,
                    on_event=self._on_redundancy_event, template=self._manager_state_dict(),
                )
        except Exception as e:  # noqa: BLE001 - fall back to the peer pull
            self._log(logging.WARNING,
                      f"shard reconstruct unavailable ({e!r}); falling back to peer heal")
            self._bump_counter("reconstruct_failures")
            return None
        self._bump_counter("reconstructs")
        self._record_timing("reconstruct_s", stats["reconstruct_s"])
        self._record_timing("reconstruct_mb_per_s", stats["mb_per_s"])
        self._record_timing("reconstruct_shards_ok", float(stats["shards_ok"]))
        self._log(logging.INFO, f"healed step {step} by parallel reconstruct: "
                                f"{stats['shards_ok']} shards ok, {stats['shards_failed']} failed, "
                                f"{stats['shards_corrupt']} corrupt, {stats['mb_per_s']:.1f} MB/s")
        return state

    def _stage_redundancy_committed(self) -> None:
        """Hand the committed composite state, labelled with the step
        about to run, to the ShardStager: the hot path pays one host
        snapshot and a queue put (``shard_stage_hot_s``, recorded when the
        interval did not skip the round). Never raises."""
        t0 = time.perf_counter()
        try:
            with self._tracer.span("shard_stage", cat="redundancy", step=self._step):
                staged = self._shard_stager.stage(self._step, self._manager_state_dict())
            if staged:
                self._record_timing("shard_stage_hot_s", time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 - the plane is advisory
            self._bump_counter("shard_stage_failed")
            logger.exception("redundancy shard staging failed")

    def last_staged_step(self) -> int:
        """The newest step this replica's stager announced (-1: none, or
        no stager)."""
        return self._shard_stager.last_staged_step() if self._shard_stager is not None else -1

    def prefetched_step(self) -> int:
        """The newest generation this hot spare holds (-1: none yet, or not
        a spare waiting for its promotion)."""
        spare = self._hot_spare
        return spare.prefetched_step() if spare is not None else -1

    def promote(self, timeout: "float | timedelta | None" = None) -> Dict[str, Any]:
        """Hot-spare promotion (reference :2837-2900): wait until the shard
        directory promotes this spare, load the freshest prefetched
        generation through the registered load fns (its tensors landed in
        place in ``state_dict_template()`` first), and only then join the
        control plane (store, manager server, heartbeat: the lighthouse
        sees the spare from here on). Returns the promotion record. A
        promoted spare stages its own generations like any leader."""
        if not self._spare or self._hot_spare is None:
            raise RuntimeError("promote() requires Manager(spare=True)")
        budget = _to_seconds(timeout) if timeout is not None else None
        result = self._hot_spare.wait_promoted(timeout=budget)
        if result is None:
            raise TimeoutError(f"spare {self._replica_id} not promoted within {budget}s")
        state_step, state, promotion = result
        # its resident generation goes with it once loaded
        self._hot_spare.shutdown()
        self._hot_spare = None
        if state is not None:
            state = place_state_like(state, self._manager_state_dict(), logger)
            self.load_user_state_dict(state.get("user", {}))
            self.load_state_dict(state["torchft"])
            self._log(logging.INFO, f"spare promoted at prefetched step {state_step} "
                                    f"(replacing {promotion.get('replaces')!r})")
        else:
            self._log(logging.WARNING, "spare promoted with no prefetched generation: joining "
                                       "cold; its first quorum heals it")
        del state
        self._join_control_plane()
        cfg = self._redundancy_cfg
        if cfg is not None and cfg.enabled:
            try:
                self._shard_stager = ShardStager(cfg, self._replica_id,
                                                 on_metric=self._on_redundancy_metric)
            except Exception:  # noqa: BLE001 - the plane is advisory
                logger.exception("promoted spare could not start its shard stager")
        self._record_timing("spare_promote_step", float(state_step))
        return promotion

    def _join_control_plane(self) -> None:
        """The leader's half of the constructor, deferred to promotion."""
        args, self._spare_join_args = self._spare_join_args, None
        self._start_control_plane(*args)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self, wait: bool = True) -> None:
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None
        # the redundancy plane first: its threads hold nothing the rest of
        # the teardown needs
        if self._shard_stager is not None:
            self._shard_stager.shutdown()
            self._shard_stager = None
        if self._hot_spare is not None:
            self._hot_spare.shutdown()
            self._hot_spare = None
        # a commit staged for a world that is going away never runs
        with self._pending_commit_lock:
            self._pending_pg_commit = None
        self._checkpoint_transport.shutdown(wait=wait)
        if self._manager is not None:
            self._manager.shutdown()
        if self._store is not None:
            self._store.shutdown()
        self._executor.shutdown(wait=wait)
        self._staging_executor.shutdown(wait=wait, cancel_futures=not wait)
        self._unpack_executor.shutdown(wait=wait, cancel_futures=not wait)
        self._pg.shutdown()
        # what the drain still holds is written before the log handlers go
        get_event_drain().flush(timeout=2.0)


def _zeros_like(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros(np.shape(x), np.asarray(x).dtype)


def _covered_seconds(start: float, end: float, intervals: List[Tuple[float, float]]) -> float:
    """Length of ``[start, end]`` covered by the union of ``intervals``."""
    if end <= start:
        return 0.0
    clipped = sorted((max(start, a), min(end, b)) for a, b in intervals if b > start and a < end)
    total = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for a, b in clipped:
        if cur_s is None:
            cur_s, cur_e = a, b
        elif a <= cur_e:
            cur_e = max(cur_e, b)
        else:
            total += cur_e - cur_s
            cur_s, cur_e = a, b
    if cur_s is not None:
        total += cur_e - cur_s
    return total


def _pipeline_overlap_stats(marks: List[Dict[str, Tuple[float, float]]]) -> Dict[str, float]:
    """Sums of one streamed allreduce's stage intervals (``marks[i]`` maps
    "pack", "wire", "unpack" to (start, end); a stage a bucket never reached
    is absent) and ``overlap_efficiency`` = sum_i |wire_i intersected with
    the union of the other buckets' stages| / sum_i |wire_i|: the share of
    wire time hidden behind other buckets (0 for one bucket). A bucket's wire
    interval runs from its submission, so it holds its wait behind the
    buckets before it on the PG's one dispatch thread and the wire sums can
    exceed the call; ``allreduce_wire_wall_s`` is the time some bucket was on
    the wire (their union), what a replica waited on its peers."""
    sums = {
        stage: sum(e - s for m in marks if stage in m for s, e in [m[stage]])
        for stage in ("pack", "wire", "unpack")
    }
    hidden = 0.0
    for i, m in enumerate(marks):
        if "wire" not in m:
            continue
        others = [iv for j, mj in enumerate(marks) if j != i for iv in mj.values()]
        hidden += _covered_seconds(*m["wire"], others)
    wires = [m["wire"] for m in marks if "wire" in m]
    wall = _covered_seconds(min(a for a, _ in wires), max(b for _, b in wires), wires) if wires else 0.0
    return {
        "allreduce_pack_s": sums["pack"],
        "allreduce_wire_s": sums["wire"],
        "allreduce_wire_wall_s": wall,
        "allreduce_unpack_s": sums["unpack"],
        "allreduce_buckets": float(len(marks)),
        "overlap_efficiency": hidden / sums["wire"] if sums["wire"] > 0 else 0.0,
    }
