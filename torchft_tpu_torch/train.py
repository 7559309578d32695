"""Fault-tolerant training of Llama or its MoE variant: the port's trainer,
per-step DDP or semi-synchronous DiLoCo.

Counterpart of ``examples/train_ddp.py``'s ``build_trainer`` and train loop,
running the Llama model. Replica groups are threads of one process on one
device (as ``tests/test_manager_integ.py`` runs them), each with its own
``Manager`` and ``ProcessGroupHost``, against an in-process lighthouse:
per-step quorum, forward and backward, the managed (optionally
fp8-quantized) gradient allreduce, the commit vote, then the optimizer
step. With the Manager's defaults the allreduce streams the gradients in
1 GiB buckets, fp8-coded with error feedback when ``quantize`` is set;
each step's log entry carries the pipeline's stage seconds and the bytes
and busy seconds of its wire. A replica told to crash raises, restarts
with a fresh model and Manager, and heals from a peer: over HTTP
(wire v3: crc32-checked chunks that resume mid-body and fail over to the
other up-to-date replicas), or with ``transport="pg"`` (``--transport
pg``) over a recovery ``ProcessGroupHost`` each replica owns, or with
``"pg-baby"`` over a ``ProcessGroupBabyHost``: the recovery PG runs in a
spawned child, made anew at every quorum change (the reference test
runner's ``transport="pg-baby"``). Either way
the heal lands in place in the replica's live model and optimizer state
on its device (the transport's template is ``Manager.state_dict_template``;
AdamW's state exists, zero, from the start so every heal carries the same
tree), and each replica reports whether its tensors kept their storage.

``--model moe`` trains the MoE family (``models/moe.py``; ``--config``
then names one of ``MOE_CONFIGS``): its loss carries the aux term, and
each step's log entry its ``aux_loss`` and ``dropped`` (the share of the
batch's token-slots past their expert's capacity). ``--remat`` is each
layer's rematerialization mode (``models/remat.py``), "full" by default,
the reference bench's choice (``bench.py:93``).

``--replicas N`` runs N replica groups (2 by default); the lighthouse
wants all of them in every quorum. ``TrainConfig.faults`` is a fault
script of ``Fault(replica, step, kind, at=...)`` entries, each fired once
when that replica reaches that step's point ``at``: ``"start"`` (before
the step's quorum, where the reference's ``EventInjector`` fires) or
``"backward"`` (after the backward pass: the step's quorum is in, so a
crash there makes the survivors discard the step; ``--fail-at N`` is
``Fault(1, N, "crash", at="backward")``). Kinds:
``crash`` (the replica raises and restarts), ``kill_heal_chunk`` and
``corrupt_heal_chunk`` (its HTTP transport drops or corrupts the serves of
``chunk``, ``times`` times, -1 for every serve), ``flake_rpc`` (the next
``times`` calls of RPC ``method``, by any replica, fail once each),
``kill_recovery_child`` (under ``pg-baby``: the next heal this replica
sends has its Baby child SIGKILLed once ``chunk`` leaf messages are
submitted; ``run_replicas(..., fleet={})`` leaves each kill's record, with
how long every replica's Baby took to show ``errored()``, in
``fleet["recovery_child_kills"]``).
``--http-timeout`` sets the HTTP transport's own timeout (its serve
socket's and its serving window's grace). ``slow`` makes a straggler: from
its step the replica sleeps on the host before each allreduce, for
``times`` steps (-1: until its Manager sees itself ejected), twice the
least ``step_s - wire_s`` of its committed steps so far (the compute the
health plane scores) each time, so its compute share rises
while its peers wait on the wire (the reference's ``slow_replica``,
``torchft_tpu/_test/event_injector.py:306``, dilates the report instead).

``--health off|observe|eject`` sets the lighthouse's health mode (the other
``TORCHFT_HEALTH_*`` knobs from the environment; unset, the mode too).
Under ``eject`` the lighthouse wants all replicas but one in a quorum, so
one can be ejected and the rest train on; a readmitted replica heals like
any replica behind, and a replica past ``--steps`` trains on until a step
every replica took part in while the lighthouse's ledger holds no replica
warned or ejected (so the run ends with all of them in, and an ejection
that lands after the last quorum of ``--steps`` is readmitted and healed
first), at most ``SETTLE_STEPS`` past ``--steps``. The
members' first incarnations start together, models built. ``--trace-dir
DIR``: each Manager dumps its span ring there when its incarnation ends
(``trace_<replica id>.json``), the trainer
merges them into ``DIR/merged_trace.json`` (``tracing.merge_traces``; open
it in Perfetto) and the lighthouse records its history in
``DIR/lighthouse_history.jsonl``; ``--profile-step N`` also runs replica
0's step N under ``torch.profiler`` (CPU and, on the card, CUDA) into
``DIR/profile_step<N>.json``, where the Manager's ``torchft::manager::*``
ranges lie beside the step's kernels. ``--policy PATH|builtin`` attaches
the adaptive policy engine (``policy.py``) to the lighthouse under
``TORCHFT_POLICY`` (``observe`` or ``enforce``; ``off``, the default,
attaches nothing); each step's log entry carries the ``policy_seq`` its
Manager last saw, and ``run_replicas(..., fleet={})`` leaves the
lighthouse's last frame in ``fleet["policy"]``.

``--redundancy K,M`` turns the redundancy plane on (``redundancy.py``):
a shard directory runs beside the lighthouse, every replica's Manager
stages its committed state as ``K`` data + ``M`` parity shards on its
peers every ``--redundancy-interval`` commits, keeping
``--redundancy-retain`` generations an owner in each store, and a heal
first reconstructs from the shards. ``--spares N`` adds hot spares
(``Manager(spare=True)``): each prefetches every generation, and when a
member ``die``s (a fault kind: a crash with no restart) the script posts
the death to the directory (``mark_dead``, its path for an operator's or
a harness's notice), which promotes a spare; the spare's ``promote()``
loads its prefetched generation into its own model and optimizer, in
place, joins the quorum and trains like any member. The directory's
announce-gap detector waits ``DEAD_AFTER_S``: its default window is
shorter than staging a bench_1b generation takes. With the plane on, a
``crash`` first waits until the other members have staged that step's
generation, so the rejoiner's heal finds it announced (the reference's
reconstruct waits at most 2 s for an announce, less than staging
bench_1b's 6.45 GB takes), and a ``die`` until another member has staged
it and every spare has prefetched it: the death of a steady fleet, whose
spare starts from the generation of the step it joins. Fault kinds of
the plane: ``corrupt_shard``
(the stores serve shard ``shard`` of replica ``owner``'s generations
with one byte flipped, ``times`` times, -1 for every serve) and
``kill_shard_source`` (they drop those serves mid-body; ``shard`` None:
every shard of the owner), the reference ``EventInjector``'s methods of
those names. Each replica's result carries ``redundancy``: its
reconstructs and their seconds and MB/s, the staging's hot-path,
snapshot, encode and put seconds, the shard counters, and for a spare
``spare_promote_step`` and the seconds ``promote()`` took.

With ``--diloco`` (``examples/train_llama_hsdp.py --diloco``,
``:158-256``) the replicas train semi-synchronously: the Manager takes the
synchronous quorum, each inner step is forward, backward and AdamW with no
allreduce, and ``DiLoCo`` syncs one fragment every ``sync_every /
num_fragments`` inner steps (its pseudogradient through the fp8 streamed
allreduce under ``--quantize``, the outer Nesterov SGD, the merge), the
allreduce overlapping ``--fragment-sync-delay`` inner steps. ``--steps``
and ``--fail-at`` count inner steps; a restarted replica learns the global
step at its first quorum and re-clamps its count to it. The defaults are
the reference's semi-sync config (sync every 20, 2 fragments, delay 1,
outer lr 0.7). A heal carries the fragments' globals and momentum too.

    python -m torchft_tpu_torch.train --config bench_1b --steps 6 \\
        --batch-size 1 --seq-len 2048 --quantize --fail-at 3 [--transport pg]
    python -m torchft_tpu_torch.train --config bench_1b --steps 40 --diloco \\
        --quantize --fail-at 14 [--transport pg]
    python -m torchft_tpu_torch.train --config bench_1b --replicas 3 --no-quantize \\
        --fail-at 2 --http-timeout 5
    python -m torchft_tpu_torch.train --model moe --config bench_moe --no-quantize \\
        --fail-at 3
    python -m torchft_tpu_torch.train --config bench_1b --replicas 3 --redundancy 2,1 \\
        --redundancy-retain 1 --spares 1 --fail-at 3

``--serve-workers N`` turns the serving plane on (``serving.py``): the
lighthouse co-hosts the snapshot registry, each replica's Manager attaches
a ``SnapshotPublisher`` over the model's parameters (by the names
``convert.py`` uses) that publishes every committed step as a versioned
delta coded in ``--serve-compress`` (fp8 by default: K3-host and K4 on the
card), and N ``ServeWorker``s on the run's device answer a closed-loop
``/infer`` load of ``SERVE_REQUESTS`` threads while a thread
samples each worker's lag in steps. A crashed incarnation's publisher
dies with it (its endpoints vanish, the registry keeps its entry); the
restarted one bootstraps from the registry. After the last step every
publisher is flushed, every worker waits for the newest version, and
``run_replicas(..., fleet={})`` leaves in ``fleet["serving"]`` whether
every worker's flat equals every publisher's ``R`` bit for bit, their
sha256 digests, the publishers' and workers' counters, the publishers'
per-version splits, the requests' latencies and failures and the lag
samples; ``main`` prints it as a last ``{"serving": ...}`` line.

A replica's result sums its resilience counters (the Manager's lifetime
counters: ``rpc_retries``, heals, ...) over all its incarnations, so what a crashed
incarnation counted (an RPC flake fired on any replica's next call) is not
lost with it.

``--plane device`` (``TrainConfig.plane``; ``host`` by default) gives
each replica's Manager a ``ProcessGroupDevice(mode="local")`` instead of
a ``ProcessGroupHost`` (the counterpart of ``benchmarks/recovery_bench.py``'s
``--plane``, ``:345``): the replica threads hand their gradients to each
other on the device and the quantized allreduce rides the packed fp8
device wire whole; a heal's recovery process group (``--transport pg``)
stays a ``ProcessGroupHost``. A step's ``wire_bytes_sent`` and
``wire_busy_s`` count the host wire, so they are 0 there.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import threading
import time
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch import coordination
from torchft_tpu_torch.checkpointing import HTTPTransport, PGTransport
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
from torchft_tpu_torch.healthwatch import HealthConfig
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import _COUNTERS, Manager
from torchft_tpu_torch.models.llama import CONFIGS, Llama
from torchft_tpu_torch.models.moe import MOE_CONFIGS, MoE
from torchft_tpu_torch.models.remat import REMAT_MODES
from torchft_tpu_torch.ops import attention as attn_ops
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.process_group import (
    ProcessGroup,
    ProcessGroupBaby,
    ProcessGroupBabyHost,
    ProcessGroupHost,
)
from torchft_tpu_torch.process_group_device import ProcessGroupDevice
from torchft_tpu_torch.tracing import merge_traces
from torchft_tpu_torch.redundancy import (
    DirectoryClient,
    RedundancyConfig,
    ShardDirectory,
    set_redundancy_fault_hook,
)
from torchft_tpu_torch.serving import ServeConfig, ServeWorker, SnapshotPublisher, flat_sha256
from torchft_tpu_torch.utils import resolve_device, tensors_sha256

__all__ = ["TrainConfig", "Fault", "InjectedFailure", "build_trainer", "run_replicas", "main"]

logger = logging.getLogger(__name__)


class InjectedFailure(Exception):
    """A scripted replica crash. ``counters`` carries the crashed
    incarnation's resilience counters to the replica's result, ``released``
    weak references to its model and Manager (``_await_release``)."""

    counters: Dict[str, float] = {}
    released: Tuple[Any, ...] = ()


class InjectedDeath(InjectedFailure):
    """A scripted permanent death: the replica does not restart.
    ``replica_id`` is its Manager's id (the directory's name for it)."""

    replica_id = ""


FAULT_KINDS = ("crash", "kill_heal_chunk", "corrupt_heal_chunk", "flake_rpc",
               "corrupt_shard", "kill_shard_source", "die", "slow", "kill_recovery_child")
# where in a step a fault fires: before its quorum, or after its backward pass
FAULT_POINTS = ("start", "backward")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault: fires once, when ``replica`` reaches point ``at``
    of ``step`` (an inner step under DiLoCo)."""

    replica: int
    step: int
    kind: str
    # the heal chunk of kill_heal_chunk / corrupt_heal_chunk; the leaf
    # messages a heal has sent when kill_recovery_child strikes
    chunk: int = 0
    times: int = 1  # serves (-1: every serve) or RPC calls that fail
    method: str = "should_commit"  # the RPC of flake_rpc
    at: str = "start"  # FAULT_POINTS
    # corrupt_shard / kill_shard_source: the shard index (None: any) of
    # replica ``owner``'s generations (-1: the replica firing the fault)
    shard: Optional[int] = None
    owner: int = -1

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected one of {FAULT_KINDS}")
        if self.at not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.at!r}: expected one of {FAULT_POINTS}")


def _baby_of(transport: Any) -> Optional[ProcessGroupBaby]:
    """The Baby recovery PG under a PGTransport, else None."""
    pg = getattr(transport, "_pg", None) if isinstance(transport, PGTransport) else None
    return pg if isinstance(pg, ProcessGroupBaby) else None


class _FaultScript:
    """The faults of one run, shared by every incarnation of a replica, so
    each fires once. ``flake_rpc`` installs a process-wide RPC fault hook,
    the shard faults a process-wide redundancy fault hook, both removed by
    ``close``. ``before_fault(replica, step, kind)``, when given, runs
    before a ``crash`` or a ``die`` fires."""

    def __init__(self, faults: Tuple[Fault, ...],
                 before_fault: Optional[Callable[[int, int, str], None]] = None) -> None:
        self._lock = threading.Lock()
        self._pending = list(faults)
        self._rpc_flakes: Dict[str, int] = {}
        # (verdict, owner prefix, shard or None) -> serves left (-1: every)
        self._shard_faults: Dict[Tuple[str, str, Optional[int]], int] = {}
        # replica -> the steps its slow fault has left (-1: until ejected)
        self._slow: Dict[int, int] = {}
        self._before_fault = before_fault
        self.fired: List[Fault] = []
        # replica -> the Baby recovery PG of its live incarnation
        self._recovery_pgs: Dict[int, ProcessGroupBaby] = {}
        # one record a kill_recovery_child that struck (_kill_child)
        self.child_kills: List[Dict[str, Any]] = []

    def check(self, replica: int, step: int, at: str, transport: Any) -> None:
        baby = _baby_of(transport)
        with self._lock:
            if baby is not None:
                self._recovery_pgs[replica] = baby
            due = [f for f in self._pending if (f.replica, f.step, f.at) == (replica, step, at)]
            for f in due:
                self._pending.remove(f)
                self.fired.append(f)
        for f in due:
            if f.kind in ("crash", "die") and self._before_fault is not None:
                self._before_fault(replica, step, f.kind)
            if f.kind == "die":
                raise InjectedDeath(f"replica {replica} died at step {step}")
            if f.kind == "crash":
                raise InjectedFailure(f"replica {replica} crashed at step {step}")
            if f.kind == "slow":
                with self._lock:
                    self._slow[replica] = f.times
            elif f.kind in ("corrupt_shard", "kill_shard_source"):
                owner = replica if f.owner < 0 else f.owner
                verdict = "corrupt" if f.kind == "corrupt_shard" else "die"
                shard = 0 if f.shard is None and verdict == "corrupt" else f.shard
                with self._lock:
                    self._shard_faults[(verdict, f"replica_{owner}:", shard)] = f.times
                set_redundancy_fault_hook(self._shard_hook)
            elif f.kind == "kill_recovery_child":
                if baby is None:
                    raise ValueError(f"{f.kind} needs the pg-baby transport")
                self._arm_child_kill(replica, step, baby, f.chunk)
            elif f.kind == "flake_rpc":
                with self._lock:
                    self._rpc_flakes[f.method] = self._rpc_flakes.get(f.method, 0) + f.times
                coordination.set_rpc_fault_hook(self._rpc_hook)
            else:
                if not isinstance(transport, HTTPTransport):
                    raise ValueError(f"{f.kind} needs the HTTP transport")
                mode = "die" if f.kind == "kill_heal_chunk" else "corrupt"
                transport.inject_chunk_fault(f.chunk, mode, times=f.times)

    def _arm_child_kill(self, replica: int, step: int, pg: "ProcessGroupBaby",
                        after: int) -> None:
        """The next heal this replica sends over ``pg`` has its Baby child
        killed (SIGKILL) once ``after`` leaf messages are submitted: the
        leaves in flight die with it, as the reference's test kills
        ``pgs[1]._gen.proc``. Then every registered Baby of the run is
        watched for ``errored()``, and the record of the kill says how
        long each took to show it."""
        send = pg.send
        sent = [0]

        def send_then_kill(arrays: Any, dst: int, tag: int = 0) -> Any:
            work = send(arrays, dst, tag)
            if tag == 2:  # a leaf (tag 1 is the header)
                sent[0] += 1
                if sent[0] == after:
                    del pg.send  # one kill: the class's send again
                    self._kill_child(replica, step, pg, after)
            return work

        pg.send = send_then_kill  # type: ignore[method-assign]

    def _kill_child(self, replica: int, step: int, pg: "ProcessGroupBaby", after: int) -> None:
        proc = pg._gen.proc
        proc.kill()
        t_kill = time.monotonic()
        record: Dict[str, Any] = {"replica": replica, "step": step, "leaves_sent": after,
                                  "pid": proc.pid, "t_kill": t_kill, "errored_after_s": {}}
        with self._lock:
            self.child_kills.append(record)
            watched = dict(self._recovery_pgs)

        def watch(j: int, baby: ProcessGroupBaby) -> None:
            deadline = t_kill + 2 * baby._timeout
            while time.monotonic() < deadline:
                if baby.errored() is not None:
                    record["errored_after_s"][j] = time.monotonic() - t_kill
                    return
                time.sleep(0.001)

        for j, baby in watched.items():
            threading.Thread(target=watch, args=(j, baby), daemon=True,
                             name=f"watch_baby_r{j}").start()

    def is_slow(self, replica: int, ejected: bool) -> bool:
        """Whether ``replica`` sleeps before this step's allreduce (a slow
        fault of ``times`` -1 ends once ``ejected``)."""
        with self._lock:
            left = self._slow.get(replica)
            if left is None:
                return False
            if left == 0 or (left < 0 and ejected):
                del self._slow[replica]
                return False
            if left > 0:
                self._slow[replica] = left - 1
            return True

    def _rpc_hook(self, method: str, addr: str) -> Optional[Exception]:
        with self._lock:
            if self._rpc_flakes.get(method, 0) <= 0:
                return None
            self._rpc_flakes[method] -= 1
        return ConnectionError(f"injected rpc flake: {method} -> {addr}")

    def _shard_hook(self, event: str, info: Dict[str, Any]) -> Optional[str]:
        """EventInjector's redundancy hook: a store's serve of an armed
        owner's shard is corrupted or dropped mid-body."""
        if event != "shard_get":
            return None
        owner, idx = str(info.get("owner", "")), int(info.get("idx", -1))
        with self._lock:
            for key, left in self._shard_faults.items():
                verdict, prefix, shard = key
                if left == 0 or not owner.startswith(prefix) or shard not in (None, idx):
                    continue
                if left > 0:
                    self._shard_faults[key] = left - 1
                return verdict
        return None

    def close(self) -> None:
        if any(f.kind == "flake_rpc" for f in self.fired):
            coordination.set_rpc_fault_hook(None)
        if any(f.kind in ("corrupt_shard", "kill_shard_source") for f in self.fired):
            set_redundancy_fault_hook(None)


REPLICAS = 2
LR = 3e-4
# the trainer's shard directory: deaths come from the fault script's
# notices; the announce-gap detector's default window (2 s) is shorter
# than staging one bench_1b generation takes, so it waits this long and
# never takes a slow stager for a death
DEAD_AFTER_S = 600.0
# timings() keys of the redundancy plane in a replica's result
REDUNDANCY_KEYS = ("reconstructs", "reconstruct_failures", "reconstruct_s", "reconstruct_mb_per_s",
                   "reconstruct_shards_ok",
                   "shard_stage_hot_s", "shard_stage_snapshot_s", "shard_encode_s", "shard_put_s",
                   "shard_stage_s", "shards_staged", "shard_stage_dropped", "shard_stage_failed",
                   "shard_put_failed", "shard_announce_rejected", "shard_corrupt",
                   "shard_fetch_failed", "spare_promote_step", "spare_prefetch_s")
# Manager.timings() keys of the streamed allreduce, copied into each step's log
PIPELINE_TIMINGS = ("allreduce_pack_s", "allreduce_wire_s", "allreduce_unpack_s",
                    "allreduce_buckets", "overlap_efficiency")
# RPC, allreduce and heal deadline: well above a bench_1b step and heal
TIMEOUT_S = 120.0
# the pg-baby transport's Baby recovery PG: each op's deadline in its
# child (one leaf of a heal) and, with 30 s more, a child's start and
# rendezvous. A heal whose source child dies fails at once; this bounds
# what a wedged child costs the step it strikes
RECOVERY_TIMEOUT_S = 30.0
# the lighthouse's wait for every heartbeating member to join a quorum
JOIN_TIMEOUT_MS = 30000
# the most steps past --steps a run trains on for its end condition
# (_RunEnd): an ejecting ledger's settling, or run_replicas' ``until``
SETTLE_STEPS = 64
# the model families --model chooses from, each with its configs
MODELS = {"llama": (Llama, CONFIGS), "moe": (MoE, MOE_CONFIGS)}
# the serving plane's closed-loop /infer load: its threads and each one's
# pause between an answer and its next request; the plane's pull and RPC
# deadline (a bench_1b full pull moves 4.3 GB)
SERVE_REQUESTS = 4
SERVE_THINK_S = 0.025
SERVE_TIMEOUT_S = 60.0


@dataclasses.dataclass
class TrainConfig:
    config: str = "bench_1b"
    # the model family: "llama" (CONFIGS) or "moe" (MOE_CONFIGS)
    model: str = "llama"
    # each layer's remat mode (REMAT_MODES): the reference bench's "full"
    # keeps two bench_1b replicas on a card
    remat: str = "full"
    steps: int = 6
    batch_size: int = 1
    seq_len: int = 2048
    quantize: bool = True
    # the Manager's process group: "host" (ProcessGroupHost) or "device"
    # (ProcessGroupDevice in local mode: the replica threads' collectives
    # stay on the device)
    plane: str = "host"
    # the heal's checkpoint transport: "http", "pg" or "pg-baby" (PGTransport
    # over a ProcessGroupBabyHost: the recovery PG in a spawned child)
    transport: str = "http"
    # semi-synchronous DiLoCo instead of the per-step allreduce; steps and
    # faults then count inner steps
    diloco: bool = False
    sync_every: int = 20
    num_fragments: int = 2
    fragment_sync_delay: int = 1
    outer_lr: float = 0.7
    # replica groups (threads); the lighthouse wants all of them
    replicas: int = REPLICAS
    # the HTTP transport's own timeout in seconds (0: TIMEOUT_S)
    http_timeout: float = 0.0
    # scripted faults, each fired once (Fault); --fail-at N is
    # Fault(1, N, "crash", at="backward")
    faults: Tuple[Fault, ...] = ()
    # the redundancy plane: (k, m) shards, k 0 = off; staged every
    # redundancy_interval commits, redundancy_retain generations an owner
    # kept in each store
    redundancy: Tuple[int, int] = (0, 1)
    redundancy_interval: int = 1
    redundancy_retain: int = 2
    # hot spares (threads beside the replicas), promoted when a member dies
    spares: int = 0
    # the lighthouse's health mode ("off", "observe", "eject"; "": the
    # environment's TORCHFT_HEALTH_MODE, observe when unset)
    health: str = ""
    # span dumps, their merge and the lighthouse's history go here ("": none)
    trace_dir: str = ""
    # replica 0 runs this step under torch.profiler, into trace_dir (-1: none)
    profile_step: int = -1
    # the serving plane: inference workers (0: off) and the deltas' codec
    serve_workers: int = 0
    serve_compress: str = "fp8"
    # the model's depth: 0 keeps the config's layers, N cuts it to N layers
    # at the config's full width
    layers: int = 0
    # the policy plane's spec on the lighthouse: a PolicySpec JSON path or
    # "builtin" ("": the lighthouse's own TORCHFT_POLICY_SPEC); the mode is
    # TORCHFT_POLICY's
    policy: str = ""


def build_trainer(cfg: TrainConfig, replica_id: int, device: torch.device):
    """The model, its AdamW optimizer and the batch source of one replica.

    Replicas initialize DIFFERENTLY (seeded by ``replica_id``): the first
    quorum's init_sync heal is what makes them identical. Batches depend on
    (replica, step) only, so a restarted replica sees the batches it would
    have seen."""
    model_cls, configs = MODELS[cfg.model]
    model_cfg = configs[cfg.config]
    if cfg.layers:
        model_cfg = dataclasses.replace(model_cfg, n_layers=cfg.layers)
    # the reference's dispatch (TORCHFT_TPU_ATTENTION, else splash for GQA on
    # the card)
    model = model_cls(model_cfg, device=device, remat=cfg.remat)
    gen = torch.Generator(device=device)
    gen.manual_seed(replica_id)
    model.init_weights(gen)
    optim = torch.optim.AdamW(model.parameters(), lr=LR)
    # AdamW's state as its first step would create it, zero: a heal before
    # that step then carries the tree every later heal does (the step
    # count where AdamW keeps it, on the CPU)
    for p in model.parameters():
        optim.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))

    def make_batch(step: int):
        g = torch.Generator(device=device)
        g.manual_seed(7919 * (step + 1) + replica_id)
        toks = torch.randint(
            0, model_cfg.vocab_size, (cfg.batch_size, cfg.seq_len + 1),
            generator=g, device=device,
        )
        return toks[:, :-1], toks[:, 1:]

    return model, optim, make_batch


def _train_replica(
    cfg: TrainConfig,
    replica_id: int,
    lighthouse_addr: str,
    device: torch.device,
    on_step: Callable[[Dict[str, Any]], None],
    stop: threading.Event,
    script: _FaultScript,
    plane: Optional[RedundancyConfig] = None,
    spare: bool = False,
    done: Optional[threading.Event] = None,
    live: Optional[Dict[int, Manager]] = None,
    shadowing: Optional[Dict[int, Manager]] = None,
    metrics_ports: Optional[Dict[int, int]] = None,
    ejecting: bool = False,
    run_end: Optional[Callable[[int], bool]] = None,
    start: Optional[threading.Barrier] = None,
    serve_cfg: Optional[ServeConfig] = None,
) -> Dict[str, Any]:
    """One incarnation of a replica (``spare``: of a hot spare, which first
    waits for its promotion and returns ``{"promoted": False}`` if
    ``done`` is set before it). ``live`` maps each running member to its
    Manager, ``shadowing`` each spare not yet promoted, ``metrics_ports``
    each member to its ``/metrics`` port. ``ejecting``: the health plane
    may eject a replica, so one that reached ``cfg.steps`` trains on until
    a step of every replica (``_all_in``). ``run_end``: past ``cfg.steps``
    it also trains on until ``run_end(step)`` says the run may end
    (``_RunEnd``). ``start``: the members' first
    incarnations meet there, models built and Managers up, before their
    first quorum. ``serve_cfg``: the serving plane's config; the
    incarnation's Manager publishes each committed step through a
    ``SnapshotPublisher``, which a finished incarnation returns under
    ``"serve_publisher"`` (alive: the run ends it) and a crashed one kills
    at once."""
    model, optim, make_batch = build_trainer(cfg, replica_id, device)

    def load_state(sd: Dict[str, Any]) -> None:
        model.load_state_dict(sd["model"])
        optim.load_state_dict(sd["optim"])

    def save_state() -> Dict[str, Any]:
        return {"model": model.state_dict(), "optim": optim.state_dict()}

    pg = _make_pg(cfg.plane)
    recovery_pg = None
    manager: Optional[Manager] = None
    transport: Any
    if cfg.transport in ("pg", "pg-baby"):
        # its own PG: one generation carries p2p or collective traffic
        recovery_pg = (ProcessGroupHost(timeout=TIMEOUT_S) if cfg.transport == "pg"
                       else ProcessGroupBabyHost(timeout=RECOVERY_TIMEOUT_S))
        transport = PGTransport(recovery_pg, timeout=TIMEOUT_S,
                                state_dict_template=lambda: manager.state_dict_template())
    elif cfg.transport == "http":
        transport = HTTPTransport(timeout=cfg.http_timeout or TIMEOUT_S,
                                  state_dict_template=lambda: manager.state_dict_template())
    else:
        raise ValueError(f"unknown transport {cfg.transport!r}")
    manager = Manager(
        pg=pg,
        load_state_dict=load_state,
        state_dict=save_state,
        min_replica_size=1,
        replica_id=f"replica_{replica_id}",
        lighthouse_addr=lighthouse_addr,
        timeout=TIMEOUT_S,
        quorum_timeout=TIMEOUT_S,
        checkpoint_transport=transport,
        # DiLoCo picks each sync's fragment from the step: every replica
        # must be in the quorum first
        use_async_quorum=not cfg.diloco,
        redundancy=plane,
        spare=spare,
    )
    tokens_per_step = cfg.batch_size * cfg.seq_len

    def sync() -> float:
        # waits for the training stream: both replica threads launch on the
        # default stream, so a replica's phase times also hold the other
        # replica's work queued in the same window; the serving plane's
        # copies and kernels on its own streams do not hold the step
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return time.perf_counter()

    optimizer = OptimizerWrapper(manager, optim)

    def storage() -> List[int]:
        # every tensor a heal lands in: the model and AdamW's state
        tensors = [*model.parameters(), *(t for st in optim.state.values() for t in st.values())]
        return [t.data_ptr() for t in tensors if isinstance(t, torch.Tensor)]

    storage0 = storage()
    promotion: Optional[Dict[str, Any]] = None
    publisher: Optional[SnapshotPublisher] = None
    # this incarnation's committed steps' step_s - wire_s, slept ones left
    # out: a slow fault sleeps twice the least (a profiled step runs long)
    compute_s: List[float] = []
    try:
        if spare:
            # shadowing: the lighthouse does not see this Manager until
            # promote() returns
            t_p = time.perf_counter()
            if shadowing is not None:
                shadowing[replica_id] = manager
            while promotion is None:
                if stop.is_set() or (done is not None and done.is_set()):
                    return {"promoted": False, "step": manager.current_step(),
                            "metrics": manager.metrics(), "timings": manager.timings()}
                try:
                    promotion = manager.promote(timeout=0.5)
                except TimeoutError:
                    continue
            if shadowing is not None:
                del shadowing[replica_id]
            promotion = {**promotion, "promote_s": time.perf_counter() - t_p,
                         "promoted_at": time.monotonic()}
        if serve_cfg is not None:
            publisher = SnapshotPublisher(manager._replica_id, config=serve_cfg)
            # the Llama's parameters by the names convert.py uses
            manager.attach_serve_publisher(publisher,
                                           params_fn=lambda: dict(model.named_parameters()))
        if live is not None:
            live[replica_id] = manager
        if metrics_ports is not None and manager.metrics_port is not None:
            metrics_ports[replica_id] = manager.metrics_port
        if start is not None:
            start.wait(timeout=TIMEOUT_S)
        if cfg.diloco:
            out = _diloco_loop(cfg, replica_id, model, optim, make_batch, manager, pg,
                               transport, sync, on_step, stop, script)
            if publisher is not None:
                out["serve_publisher"], publisher = publisher, None
            return out
        while manager.current_step() < cfg.steps or (
                run_end is not None
                and not ((not ejecting or _all_in(manager, cfg))
                         and run_end(manager.current_step()))):
            if stop.is_set():
                raise RuntimeError(f"replica {replica_id}: a peer replica failed")
            step = manager.current_step()
            script.check(replica_id, step, "start", transport)
            profiling = replica_id == 0 and step == cfg.profile_step and cfg.trace_dir
            with _step_profiler(device) if profiling else contextlib.nullcontext() as prof:
                t0 = sync()
                optimizer.zero_grad()
                inputs, targets = make_batch(step)
                loss = model.loss(inputs, targets)
                loss.backward()
                t1 = sync()
                script.check(replica_id, step, "backward", transport)
                slow = script.is_slow(replica_id, manager.health().get("ejections", 0) > 0)
                if slow:
                    time.sleep(max(0.0, 2.0 * min(compute_s or [0.0])))
                t_slow = time.perf_counter()
                grads = {n: p.grad for n, p in model.named_parameters()}
                wire0 = _wire_stats(pg)
                avg = manager.allreduce(grads, should_quantize=cfg.quantize).get_future().wait()
                for n, p in model.named_parameters():
                    p.grad = avg[n]
                t2 = sync()
                wire1 = _wire_stats(pg)
                timings = manager.timings()
                committed = optimizer.step()
                t3 = sync()
            if prof is not None:
                prof.export_chrome_trace(os.path.join(cfg.trace_dir, f"profile_step{step}.json"))
            if committed and not slow and not manager.last_quorum_healed():
                compute_s.append(t3 - t0 - timings.get("allreduce_wire_wall_s", 0.0))
            on_step({
                "replica": replica_id,
                # the step the vote decided (a heal moves a replica forward)
                "step": manager.current_step() - 1 if committed else manager.current_step(),
                "loss": loss.item(),
                "participants": manager.num_participants(),
                "committed": committed,
                "healed": manager.last_quorum_healed(),
                # the attention this step's layers resolved to, so a silent
                # "xla" shows
                "attention": attn_ops.LAST_DISPATCH,
                "step_ms": (t3 - t0) * 1e3,
                # quorum join + forward + backward
                "compute_ms": (t1 - t0) * 1e3,
                "allreduce_ms": (t2 - t1) * 1e3,
                "tokens_per_s": tokens_per_step / (t3 - t0),
                # the streamed pipeline's stages, summed over buckets (the
                # last streamed allreduce's: absent before the first)
                **{k: timings.get(k, 0.0) for k in PIPELINE_TIMINGS},
                # this step's wire
                "wire_bytes_sent": wire1["bytes_sent"] - wire0["bytes_sent"],
                "wire_busy_s": wire1["busy_s"] - wire0["busy_s"],
                # the redundancy plane's hot path on a step that staged
                # (within compute_ms), and when the step ended (monotonic
                # clock)
                "stage_hot_ms": timings.get("shard_stage_hot_s", 0.0) * 1e3,
                # a slow fault's host sleep (within allreduce_ms), and the
                # health plane's state of this replica after the vote
                "slow_ms": (t_slow - t1) * 1e3 if slow else 0.0,
                "health_state": manager.timings()["health_state"],
                # the commit path's hand-off to the serve publisher
                "serve_publish_ms": manager.timings().get("serve_publish_s", 0.0) * 1e3,
                # the newest policy frame this Manager saw at a safe point
                "policy_seq": manager.timings()["policy_seq"],
                "at": time.monotonic(),
                **_moe_stats(model),
            })
        out = {
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "step": manager.current_step(),
            # whether the model and AdamW's state kept their storage through
            # the heals and a promotion (every path lands in place)
            "storage_kept": storage() == storage0,
            "metrics": manager.metrics(),
            "timings": manager.timings(),
        }
        if promotion is not None:
            out["promotion"] = promotion
        if publisher is not None:
            out["serve_publisher"], publisher = publisher, None
        return out
    except InjectedFailure as e:
        if publisher is not None:
            # the source dies with its replica: endpoints gone, its registry
            # entry left for the workers to fail over from
            publisher.kill()
        e.counters = _resilience(manager)
        e.released = (weakref.ref(model), weakref.ref(manager))
        if isinstance(e, InjectedDeath):
            e.replica_id = manager._replica_id
        raise
    finally:
        if publisher is not None:
            publisher.shutdown()
        if live is not None and live.get(replica_id) is manager:
            del live[replica_id]
        if metrics_ports is not None and manager.metrics_port is not None \
                and metrics_ports.get(replica_id) == manager.metrics_port:
            del metrics_ports[replica_id]
        if shadowing is not None and shadowing.get(replica_id) is manager:
            del shadowing[replica_id]
        if cfg.trace_dir:
            manager.dump_trace(os.path.join(cfg.trace_dir, f"trace_{manager.tracer.replica_id}.json"))
        manager.shutdown(wait=False)
        if recovery_pg is not None:
            recovery_pg.shutdown()


def _make_pg(plane: str) -> ProcessGroup:
    """A replica's Manager process group for ``plane``."""
    if plane == "host":
        return ProcessGroupHost(timeout=TIMEOUT_S)
    if plane == "device":
        return ProcessGroupDevice(timeout=TIMEOUT_S, mode="local")
    raise ValueError(f"unknown plane {plane!r}: host or device")


def _wire_stats(pg: ProcessGroup) -> Dict[str, float]:
    """The host wire's counters (a device-plane group has no host wire)."""
    stats = getattr(pg, "wire_stats", None)
    return stats() if stats is not None else {"bytes_sent": 0, "busy_s": 0.0}


def _await_release(refs: Tuple[Any, ...], timeout: float) -> bool:
    """Collect until every weak reference in ``refs`` is dead (True), or
    ``timeout`` passed (False). A crashed incarnation's Manager shuts down
    without waiting for its threads, and one still in flight (a quorum
    thread retrying its RPC against the stopped server, longer on a loaded
    host) holds the Manager, and through its state-dict closures the model,
    past a single collection."""
    deadline = time.monotonic() + timeout
    while True:
        gc.collect()
        if all(r() is None for r in refs):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.02)


class _RunEnd:
    """Whether a run past ``cfg.steps`` may end at ``step``: when every
    check says so, or at ``bound``. One answer a step, shared by the
    replica threads, which ask at the same step at slightly different
    times: they stop at one step."""

    def __init__(self, checks: List[Callable[[int], bool]], bound: int) -> None:
        self._checks = checks
        self._bound = bound
        self._answers: Dict[int, bool] = {}
        self._lock = threading.Lock()

    def __call__(self, step: int) -> bool:
        with self._lock:
            if step not in self._answers:
                self._answers[step] = step >= self._bound or all(c(step) for c in self._checks)
            return self._answers[step]


def _ledger_settled(addr: str) -> Callable[[int], bool]:
    """The ejecting run's check: the lighthouse's ledger holds no replica
    warned or ejected, so a straggler's ejection that lands after the last
    quorum of ``cfg.steps`` was formed is readmitted and healed before the
    run ends."""
    client = LighthouseClient(addr)

    def settled(step: int) -> bool:
        states = {r.get("state") for r in client.health().get("replicas", {}).values()}
        return not states & {"warn", "ejected"}

    return settled


def _all_in(manager: Manager, cfg: TrainConfig) -> bool:
    """Whether the last step's quorum had every replica taking part. With
    ejection on, a replica past ``cfg.steps`` trains on until it does: an
    ejected replica then rejoins and heals before its peers stop, and every
    member of that quorum sees the same answer, so they stop at one step."""
    return manager.num_participants() >= cfg.replicas


def _step_profiler(device: torch.device) -> "torch.profiler.profile":
    """A profiler of one step: the host's ranges and operators, and on the
    card its kernels, in one Kineto trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _resilience(manager: Manager) -> Dict[str, float]:
    """What a replica's result sums over its incarnations: the Manager's
    lifetime counters of ``timings()`` and ``metrics()``'s heals."""
    timings = manager.timings()
    return {**{k: timings[k] for k in _COUNTERS}, "heals": manager.metrics()["heals"]}


def _moe_stats(model: Llama) -> Dict[str, float]:
    """The MoE's aux loss and dropped share of the step (nothing for Llama)."""
    if not isinstance(model, MoE):
        return {}
    return {"aux_loss": model.last_aux.item(), "dropped": model.last_dropped.item()}


def _diloco_loop(cfg: TrainConfig, replica_id: int, model: Llama, optim: torch.optim.Optimizer,
                 make_batch: Callable, manager: Manager, pg: ProcessGroup, transport: Any,
                 sync: Callable[[], float], on_step: Callable[[Dict[str, Any]], None],
                 stop: threading.Event, script: _FaultScript) -> Dict[str, Any]:
    """Inner AdamW steps with a DiLoCo step after each; returns the final
    parameters and fragment state (the live tensors: the replica is done)."""
    params = dict(model.named_parameters())
    diloco = DiLoCo(
        manager, params,
        lambda ps: torch.optim.SGD(ps, lr=cfg.outer_lr, momentum=0.9, nesterov=True),
        sync_every=cfg.sync_every, num_fragments=cfg.num_fragments,
        fragment_sync_delay=cfg.fragment_sync_delay, should_quantize=cfg.quantize,
        # a heal lands in these tensors in place: the tree stays valid
        get_params=lambda: params,
    )
    # the per-fragment cycle DiLoCo derived from the real partition
    per_cycle = diloco.sync_every

    def storage() -> List[int]:
        # every tensor a heal lands in: model, AdamW state, fragment state
        tensors = [*params.values(), *(t for st in optim.state.values() for t in st.values()),
                   *diloco.state_tensors()]
        return [t.data_ptr() for t in tensors if isinstance(t, torch.Tensor)]

    storage0 = storage()
    tokens_per_step = cfg.batch_size * cfg.seq_len
    inner = 0
    while inner < cfg.steps:
        if stop.is_set():
            raise RuntimeError(f"replica {replica_id}: a peer replica failed")
        script.check(replica_id, inner, "start", transport)
        t0 = sync()
        optim.zero_grad()
        inputs, targets = make_batch(inner)
        loss = model.loss(inputs, targets)
        loss.backward()
        script.check(replica_id, inner, "backward", transport)
        optim.step()
        t1 = sync()
        wire0 = _wire_stats(pg)
        commits0 = manager.metrics()["commits"]
        diloco.step(params)
        t2 = sync()
        wire1 = _wire_stats(pg)
        syncs = diloco.last_step_syncs
        entry: Dict[str, Any] = {
            "replica": replica_id,
            "inner_step": inner,
            # the committed outer steps so far (a heal moves it forward)
            "outer_step": manager.current_step(),
            "loss": loss.item(),
            "attention": attn_ops.LAST_DISPATCH,
            # "prepare" (quorum, pseudogradient, allreduce issued) and/or
            # "perform" (wait, vote, outer step, merge), with the fragment
            "sync": [f"{kind}:{frag}" for kind, frag in syncs],
            "healed": any(kind == "prepare" for kind, _ in syncs) and manager.last_quorum_healed(),
            "step_ms": (t2 - t0) * 1e3,
            # forward + backward + AdamW
            "inner_ms": (t1 - t0) * 1e3,
            "diloco_ms": (t2 - t1) * 1e3,
            "tokens_per_s": tokens_per_step / (t2 - t0),
            "wire_bytes_sent": wire1["bytes_sent"] - wire0["bytes_sent"],
            "wire_busy_s": wire1["busy_s"] - wire0["busy_s"],
            **_moe_stats(model),
        }
        performed = [frag for kind, frag in syncs if kind == "perform"]
        if performed:
            frag = diloco.fragments[performed[0]]
            timings = manager.timings()
            entry.update({
                "committed": manager.metrics()["commits"] > commits0,
                # issue to completion of the fragment's allreduce, and of
                # it the wait at the perform
                "sync_allreduce_ms": frag.last_allreduce_s * 1e3,
                "sync_wait_ms": frag.last_wait_s * 1e3,
                "participants": manager.num_participants(),
                **{k: timings.get(k, 0.0) for k in PIPELINE_TIMINGS},
            })
        on_step(entry)
        # committed outer steps are the global clock (train_llama_hsdp.py:240)
        inner = max(inner + 1, manager.current_step() * per_cycle)
    diloco.flush(params)
    return {
        "params": {n: p.detach() for n, p in model.named_parameters()},
        # every fragment's globals and momentum (DiLoCo.state_tensors)
        "fragment_state": diloco.state_tensors(),
        "step": manager.current_step(),
        "inner_steps": inner,
        # whether every live tensor kept its storage through the heals (a
        # heal lands in place through the transport's template)
        "storage_kept": storage() == storage0,
        "metrics": manager.metrics(),
        "timings": manager.timings(),
    }


def run_replicas(
    cfg: TrainConfig,
    device: "str | torch.device | None" = None,
    on_step: Optional[Callable[[Dict[str, Any]], None]] = None,
    fleet: Optional[Dict[str, Any]] = None,
    until: Optional[Callable[[int], bool]] = None,
    max_steps: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Train ``cfg.replicas`` replica groups (and ``cfg.spares`` hot spares)
    as threads against an in-process lighthouse; returns each one's final
    state, metrics and per-step log, the spares after the replicas. A
    crashed replica restarts (with a fresh model and Manager) until it
    finishes; one that ``die``s does not, and its result says ``died``.
    ``fleet``, when given, is filled as the run goes: ``lighthouse`` (its
    address, while it serves), ``metrics_ports`` (replica -> its Manager's
    ``/metrics`` port, while it runs and serves one), and at the end
    ``health`` (the lighthouse's ``/health`` payload), with a
    ``trace_dir``, ``trace`` (the merged trace's path), and with serve
    workers ``serving`` (``_finish_serving``), and ``policy`` (the
    lighthouse's last policy frame). ``until(step)``: the replicas train
    past ``cfg.steps`` until it answers True, asked once a step (the answer
    shared by the replicas); ``max_steps`` bounds that, and an ejecting
    run's settling (default ``cfg.steps + SETTLE_STEPS``)."""
    dev = resolve_device(device)
    n_replicas = cfg.replicas
    n_all = n_replicas + cfg.spares
    k, m = cfg.redundancy
    if not k and (cfg.spares or any(f.kind == "die" for f in cfg.faults)):
        raise ValueError("hot spares and a `die` fault need the redundancy plane "
                         "(redundancy k >= 1)")
    health = HealthConfig.from_env()
    if cfg.health:
        health = dataclasses.replace(health, mode=cfg.health)
        health.validate()
    history = ""
    if cfg.trace_dir:
        os.makedirs(cfg.trace_dir, exist_ok=True)
        history = os.path.join(cfg.trace_dir, "lighthouse_history.jsonl")
    # min_replicas = every member holds the survivors in quorum while a
    # crashed replica restarts, so the rejoin always goes through a heal
    # (with the plane on: of the generation staged before the crash); an
    # ejecting health plane needs one member to spare, and then the join
    # timeout must outlast a heal source's serving grace (10 s): a quorum
    # formed without the member still in its grace would leave it behind
    # to heal in turn, and so on
    serving = cfg.serve_workers > 0
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=max(1, n_replicas - 1) if health.mode == "eject" else n_replicas,
        join_timeout_ms=JOIN_TIMEOUT_MS, quorum_tick_ms=20, heartbeat_timeout_ms=2000,
        health=health.to_json(), history_path=history, serve_registry=serving,
        policy=cfg.policy or None,
    )
    addr = f"127.0.0.1:{lighthouse.port}"
    if fleet is not None:
        fleet["lighthouse"] = addr
        fleet["metrics_ports"] = {}
    serve_cfg: Optional[ServeConfig] = None
    workers: List[ServeWorker] = []
    traffic: Optional[_ServeTraffic] = None
    if serving:
        serve_cfg = ServeConfig.from_env(registry=lighthouse.serve_registry_url(),
                                         compress=cfg.serve_compress, timeout_s=SERVE_TIMEOUT_S)
        workers = [ServeWorker(serve_cfg.registry, config=serve_cfg, name=f"worker_{i}",
                               device=dev) for i in range(cfg.serve_workers)]
        traffic = _ServeTraffic(workers, lighthouse.serve_registry, SERVE_REQUESTS, SERVE_THINK_S)
    plane = directory = None
    if k > 0:
        # the shard directory beside the lighthouse, polling its health
        directory = ShardDirectory(lighthouse_addr=addr, dead_after_s=DEAD_AFTER_S)
        plane = RedundancyConfig(
            k=k, m=m, directory=directory.url, interval=cfg.redundancy_interval,
            retain=cfg.redundancy_retain, timeout_s=TIMEOUT_S,
        )
        plane.validate()
    # set when a replica fails for real: the others stop at their next step
    # instead of waiting in quorum for a peer that will not come back
    stop = threading.Event()
    errors: List[BaseException] = []
    logs: List[List[Dict[str, Any]]] = [[] for _ in range(n_all)]
    live: Dict[int, Manager] = {}
    shadowing: Dict[int, Manager] = {}
    # set once every member's thread has ended: an unpromoted spare stops
    done = threading.Event()
    members_left = [n_replicas]
    # the members' first incarnations start training together
    start = threading.Barrier(n_replicas)

    def before_fault(replica: int, step: int, kind: str) -> None:
        # a crash waits until every other member announced this step's
        # generation: the restarted replica's heal needs one (see the
        # module docstring), and one staged after the crash would place no
        # shard on the crashed replica's store (a member whose interval
        # skips this step holds the wait to its bound). A death waits
        # until another member announced it and every spare holds it. With
        # serving on, a crash or death first lets the replica's publisher
        # announce its last commit: the dead source then holds the newest
        # version, as one that dies between an announce and its next commit
        mgr = live.get(replica)
        pub = getattr(mgr, "_serve_publisher", None)
        if pub is not None:
            pub.flush(timeout=TIMEOUT_S)
        if plane is None:
            return
        deadline = time.monotonic() + TIMEOUT_S
        while time.monotonic() < deadline and not stop.is_set():
            staged = [mgr.last_staged_step() >= step
                      for j, mgr in list(live.items()) if j != replica]
            if kind == "crash" and all(staged):
                return
            if kind == "die" and any(staged) and all(
                    mgr.prefetched_step() >= step for mgr in list(shadowing.values())):
                return
            time.sleep(0.01)

    script = _FaultScript(cfg.faults, before_fault=before_fault)
    log_lock = threading.Lock()
    checks = ([_ledger_settled(addr)] if health.mode == "eject" else []) + (
        [until] if until is not None else [])
    run_end = _RunEnd(checks, cfg.steps + SETTLE_STEPS if max_steps is None else max_steps) \
        if checks else None

    def record(entry: Dict[str, Any]) -> None:
        with log_lock:
            logs[entry["replica"]].append(entry)
            if on_step is not None:
                on_step(entry)

    def replica(i: int) -> Dict[str, Any]:
        restarts = 0
        # the crashed incarnations' resilience counters
        carried: Dict[str, float] = {}
        spare = i >= n_replicas
        died: Optional[Dict[str, Any]] = None
        try:
            while died is None:
                try:
                    out = _train_replica(cfg, i, addr, dev, record, stop, script, plane=plane,
                                         spare=spare and restarts == 0, done=done, live=live,
                                         shadowing=shadowing,
                                         metrics_ports=None if fleet is None
                                         else fleet["metrics_ports"],
                                         ejecting=health.mode == "eject",
                                         run_end=run_end,
                                         start=None if spare or restarts else start,
                                         serve_cfg=serve_cfg)
                    out["restarts"] = restarts
                    # this incarnation's own heals (a restart's rejoin)
                    out["last_incarnation"] = {
                        key: out["timings"].get(key, 0.0)
                        for key in ("reconstructs", "reconstruct_failures", "heal_attempts")}
                    for k_, n in carried.items():
                        (out["metrics"] if k_ == "heals" else out["timings"])[k_] += n
                    return out
                except InjectedDeath as e:
                    for k_, n in e.counters.items():
                        carried[k_] = carried.get(k_, 0) + n
                    died = {"died": True, "died_at": time.monotonic(), "replica_id": e.replica_id,
                            "restarts": restarts, "counters": carried}
                    released = e.released
                except InjectedFailure as e:
                    restarts += 1
                    for k_, n in e.counters.items():
                        carried[k_] = carried.get(k_, 0) + n
                    released = e.released
                except BaseException as e:
                    with log_lock:
                        if not stop.is_set():
                            errors.append(e)
                            stop.set()
                    # the members still waiting to start fail at once
                    start.abort()
                    raise
                # past the handler (the crash's traceback is gone): the crashed
                # or dead incarnation's model, optimizer state and EF residuals
                # sit in reference cycles (its PGTransport's template closure
                # holds its Manager); free them before the restart, or the
                # spare promoted in a dead one's place, allocates its own, or
                # the card holds both
                if not _await_release(released, JOIN_TIMEOUT_MS / 1000):
                    logger.warning("replica %d: the crashed incarnation's model is still "
                                   "referenced %.0f s after its shutdown; restarting beside it",
                                   i, JOIN_TIMEOUT_MS / 1000)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            # the death notice, once the dead replica's memory is freed
            DirectoryClient(plane.directory, timeout=TIMEOUT_S).mark_dead(died["replica_id"])
            return died
        finally:
            if not spare:
                with log_lock:
                    members_left[0] -= 1
                    if members_left[0] == 0:
                        done.set()

    futs: List[Any] = []
    try:
        with ThreadPoolExecutor(max_workers=n_all) as ex:
            futs = [ex.submit(replica, i) for i in range(n_all)]
            for f in futs:
                f.exception()
        if fleet is not None:
            fleet["health"] = LighthouseClient(addr).health()
            fleet["policy"] = lighthouse.policy()
            fleet["recovery_child_kills"] = script.child_kills
        if serving and not errors:
            summary = _finish_serving(
                [(i, f.result()["serve_publisher"]) for i, f in enumerate(futs)
                 if "serve_publisher" in f.result()], workers, traffic, serve_cfg)
            if fleet is not None:
                fleet["serving"] = summary
    finally:
        if fleet is not None:
            fleet.pop("lighthouse", None)
        if traffic is not None:
            traffic.stop()
        for w in workers:
            w.shutdown()
        for f in futs:
            pub = f.result().pop("serve_publisher", None) if f.done() and not f.exception() \
                else None
            if pub is not None:
                pub.shutdown()
        script.close()
        if directory is not None:
            directory.shutdown()
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    if cfg.trace_dir:
        # every incarnation's dump of this run, one process row each
        dumps = []
        for name in sorted(os.listdir(cfg.trace_dir)):
            if name.startswith("trace_") and name.endswith(".json"):
                with open(os.path.join(cfg.trace_dir, name)) as f:
                    dumps.append(json.load(f))
        merged = os.path.join(cfg.trace_dir, "merged_trace.json")
        with open(merged, "w") as f:
            json.dump(merge_traces(dumps), f)
        if fleet is not None:
            fleet["trace"] = merged
    results = [f.result() for f in futs]
    for i, r in enumerate(results):
        r["log"] = logs[i]
        if plane is not None and "timings" in r:
            r["redundancy"] = {key: r["timings"][key] for key in REDUNDANCY_KEYS
                               if key in r["timings"]}
    return results


class _ServeTraffic:
    """The serving plane's closed-loop ``/infer`` load: ``n_threads``
    request threads, each sending its next request to the next worker
    ``think_s`` after the last one was answered (over HTTP: every request
    runs Python on both ends, under the GIL the trainers dispatch their
    kernels under, so requests with no pause starve them), once every
    worker has applied a version (requests before the first snapshot lands
    are not the plane's), and a thread sampling each worker's lag in steps
    (the registry's newest version's step minus the worker's) every 50 ms.
    A request fails when it raises or answers no result."""

    def __init__(self, workers: List[ServeWorker], registry: Any, n_threads: int,
                 think_s: float, timeout_s: float = 30.0) -> None:
        self._workers = workers
        self._think_s = think_s
        self._registry = registry
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.latencies_ms: List[float] = []
        self.failures: List[str] = []
        self.lag_steps: Dict[str, List[int]] = {w.name: [] for w in workers}
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self._threads = [threading.Thread(target=self._requests, args=(t, n_threads), daemon=True,
                                          name=f"serve_traffic_{t}") for t in range(n_threads)]
        self._threads.append(threading.Thread(target=self._sample_lag, daemon=True,
                                              name="serve_lag"))
        for th in self._threads:
            th.start()

    def _requests(self, tid: int, n_threads: int) -> None:
        while not self._stop.is_set() and any(w.version is None for w in self._workers):
            time.sleep(0.02)
        with self._lock:
            if self.started_at is None:
                self.started_at = time.perf_counter()
        i = 0
        while not self._stop.is_set():
            w = self._workers[(tid + i) % len(self._workers)]
            seed = tid * 1_000_003 + i
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(f"{w.url}/infer?seed={seed}",
                                            timeout=self._timeout_s) as r:
                    body = json.loads(r.read().decode())
                err = None if r.status == 200 and body.get("result") is not None \
                    else f"bad body: {body}"
            except Exception as e:  # noqa: BLE001 - a failure is what is counted
                err = repr(e)
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                if err is None:
                    self.latencies_ms.append(dt_ms)
                else:
                    self.failures.append(err)
            i += n_threads
            self._stop.wait(self._think_s)

    def _sample_lag(self) -> None:
        while not self._stop.wait(0.05):
            latest = self._registry.sources().get("latest")
            if latest is None:
                continue
            for w in self._workers:
                v = w.version
                if v is not None:
                    with self._lock:
                        self.lag_steps[w.name].append(max(0, int(latest[1]) - v[1]))

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=self._timeout_s + 1.0)
        if self.stopped_at is None:
            self.stopped_at = time.perf_counter()


def _finish_serving(publishers: List[Tuple[int, SnapshotPublisher]], workers: List[ServeWorker],
                    traffic: _ServeTraffic, serve_cfg: ServeConfig) -> Dict[str, Any]:
    """After the last step: flush every finished incarnation's publisher,
    wait until every worker applied the newest version, stop the traffic,
    compare every worker's flat with every publisher's ``R`` (on their
    device, one copy at a time), then digest all of them at once."""
    deadline = 4 * serve_cfg.timeout_s
    for _, pub in publishers:
        if not pub.flush(timeout=deadline):
            raise RuntimeError(f"serve publisher {pub.replica_id} did not drain its queue")
    versions = [pub.version for _, pub in publishers if pub.version is not None]
    if not versions:
        raise RuntimeError("no serve publisher published a version")
    target = max(versions)
    for w in workers:
        if not w.wait_version(target, timeout=deadline):
            raise RuntimeError(f"serve worker {w.name} stuck at {w.version}, newest {target}")
    traffic.stop()
    flats = {**{f"publisher_{i}": pub.ref_flat for i, pub in publishers},
             **{w.name: w.params_flat for w in workers}}
    base = publishers[0][1].ref_flat()
    equal = True
    for fn in flats.values():
        flat = fn()
        equal = equal and flat is not None and torch.equal(flat, base)
        del flat
    del base
    with ThreadPoolExecutor(len(flats)) as ex:
        digests = dict(zip(flats, ex.map(lambda fn: flat_sha256(fn()), flats.values())))
    seconds = (traffic.stopped_at or 0.0) - (traffic.started_at or 0.0)
    return {
        "equal": equal,
        "target": list(target),
        "publishers": [{"replica": i, "replica_id": pub.replica_id,
                        "version": list(pub.version) if pub.version else None,
                        "counters": dict(pub.counters), "splits": list(pub.splits),
                        # the retained versions, oldest first
                        "ring": pub.manifest()["deltas"],
                        "ref_sha256": digests[f"publisher_{i}"]} for i, pub in publishers],
        "workers": [{"name": w.name, "version": list(w.version) if w.version else None,
                     "counters": dict(w.counters), "full_pull_s": list(w.full_pull_s),
                     "delta_pull_s": list(w.delta_pull_s), "flat_sha256": digests[w.name],
                     "lag_steps": list(traffic.lag_steps[w.name])} for w in workers],
        "requests": {"ok": len(traffic.latencies_ms), "failed": list(traffic.failures),
                     "latency_ms": list(traffic.latencies_ms), "seconds": max(seconds, 0.0)},
    }


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama", choices=sorted(MODELS),
                   help="the model family: llama (CONFIGS) or moe (MOE_CONFIGS)")
    p.add_argument("--config", default="bench_1b",
                   help="a config of the model family (llama: %s; moe: %s)"
                        % (", ".join(sorted(CONFIGS)), ", ".join(sorted(MOE_CONFIGS))))
    p.add_argument("--remat", default="full", choices=REMAT_MODES,
                   help="each layer's rematerialization mode")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the model to this many layers at its full width (0: the config's)")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--quantize", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fail-at", type=int, default=None,
                   help="replica 1 crashes after this step's backward pass")
    p.add_argument("--replicas", type=int, default=REPLICAS,
                   help="replica groups (threads); the lighthouse wants all of them")
    p.add_argument("--plane", choices=["host", "device"], default="host",
                   help="the Manager's process group: host (ProcessGroupHost, the TCP wire) "
                        "or device (ProcessGroupDevice in local mode: collectives stay on "
                        "the device)")
    p.add_argument("--transport", choices=["http", "pg", "pg-baby"], default="http",
                   help="heal transport: http, pg (a recovery process group) or pg-baby (a "
                        "recovery process group in a spawned child process)")
    p.add_argument("--http-timeout", type=float, default=0.0,
                   help="the HTTP transport's own timeout in seconds (default: the "
                        f"trainer's {TIMEOUT_S:.0f} s)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--diloco", action="store_true",
                   help="semi-sync across replica groups (DiLoCo) instead of the per-step "
                        "allreduce; --steps and --fail-at count inner steps")
    p.add_argument("--sync-every", type=int, default=20)
    p.add_argument("--num-fragments", type=int, default=2)
    p.add_argument("--fragment-sync-delay", type=int, default=1)
    p.add_argument("--outer-lr", type=float, default=0.7)
    p.add_argument("--redundancy", default="0,1", metavar="K,M",
                   help="the redundancy plane: K data + M parity shards a staged generation "
                        "(K 0: off)")
    p.add_argument("--redundancy-interval", type=int, default=1,
                   help="stage every N commits")
    p.add_argument("--redundancy-retain", type=int, default=2,
                   help="generations an owner kept in each shard store")
    p.add_argument("--spares", type=int, default=0,
                   help="hot spares, promoted when a member dies (needs --redundancy)")
    p.add_argument("--health", default="", choices=["", "off", "observe", "eject"],
                   help="the lighthouse's health mode (default: $TORCHFT_HEALTH_MODE, else "
                        "observe); eject drops a straggler from the quorum until readmitted")
    p.add_argument("--trace-dir", default="",
                   help="each replica's span dump, their merge (merged_trace.json) and the "
                        "lighthouse's history go here")
    p.add_argument("--profile-step", type=int, default=-1,
                   help="replica 0 runs this step under torch.profiler, into --trace-dir")
    p.add_argument("--serve-workers", type=int, default=0,
                   help="the serving plane: inference workers on the run's device answering a "
                        "closed-loop /infer load from the replicas' published snapshots "
                        "(0: off)")
    p.add_argument("--serve-compress", default="fp8", choices=["off", "fp8", "int8"],
                   help="the codec of the published deltas")
    p.add_argument("--policy", default="", metavar="PATH|builtin",
                   help="attach the adaptive policy engine to the lighthouse with this spec; "
                        "TORCHFT_POLICY (observe or enforce) is the mode (default: the "
                        "environment's TORCHFT_POLICY_SPEC)")
    args = p.parse_args(argv)
    try:
        red_k, red_m = (int(x) for x in args.redundancy.split(","))
    except ValueError:
        p.error(f"--redundancy takes K,M (two integers), not {args.redundancy!r}")
    if args.config not in MODELS[args.model][1]:
        p.error(f"--config {args.config!r} is not a {args.model} config: "
                f"{sorted(MODELS[args.model][1])}")
    cfg = TrainConfig(
        config=args.config, model=args.model, remat=args.remat, layers=args.layers,
        steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, quantize=args.quantize,
        faults=() if args.fail_at is None else (Fault(1, args.fail_at, "crash", at="backward"),),
        plane=args.plane, transport=args.transport, diloco=args.diloco,
        sync_every=args.sync_every, num_fragments=args.num_fragments,
        fragment_sync_delay=args.fragment_sync_delay, outer_lr=args.outer_lr,
        replicas=args.replicas, http_timeout=args.http_timeout,
        redundancy=(red_k, red_m), redundancy_interval=args.redundancy_interval,
        redundancy_retain=args.redundancy_retain, spares=args.spares,
        health=args.health, trace_dir=args.trace_dir, profile_step=args.profile_step,
        serve_workers=args.serve_workers, serve_compress=args.serve_compress,
        policy=args.policy,
    )
    # the serving plane's summary comes back in the fleet dict
    fleet: Dict[str, Any] = {}
    results = run_replicas(
        cfg, args.device, on_step=lambda e: print(json.dumps(e), flush=True),
        **({"fleet": fleet} if cfg.serve_workers else {}),
    )
    digests = []
    for i, r in enumerate(results):
        losses = [e["loss"] for e in r["log"]]
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"replica {i}: non-finite loss")
        if r.get("died") or r.get("promoted") is False:
            print(json.dumps({"replica": i, "died": bool(r.get("died")),
                              "promoted": r.get("promoted", True)}), flush=True)
            continue
        line = {"replica": i, "step": r["step"], "restarts": r["restarts"],
                "metrics": r["metrics"]}
        if "redundancy" in r:
            line["redundancy"] = r["redundancy"]
        if cfg.diloco:
            line["fragments_sha256"] = tensors_sha256(r["fragment_state"])
            digests.append(line["fragments_sha256"])
        print(json.dumps(line), flush=True)
    if len(set(digests)) > 1:
        raise SystemExit(f"replicas' fragment state differs: {digests}")
    if "serving" in fleet:
        sv = fleet["serving"]
        lat = sorted(sv["requests"]["latency_ms"])
        print(json.dumps({"serving": {
            "equal": sv["equal"], "target": sv["target"],
            "publishers": [{k: p[k] for k in ("replica", "version", "counters", "ref_sha256")}
                           for p in sv["publishers"]],
            "workers": [{k: w[k] for k in ("name", "version", "counters", "flat_sha256")}
                        for w in sv["workers"]],
            "requests_ok": sv["requests"]["ok"], "requests_failed": len(sv["requests"]["failed"]),
            "infer_p50_ms": lat[len(lat) // 2] if lat else None}}), flush=True)
        if not sv["equal"] or sv["requests"]["failed"]:
            raise SystemExit("serving: workers and publishers differ or requests failed")


if __name__ == "__main__":
    main()
