"""Fault-tolerant HSDP Llama training: the port's counterpart of
``examples/train_llama_hsdp.py``.

A replica group is ``fsdp * sp * tp`` rank processes (the reference runs it
as one process over an XLA SPMD mesh; PyTorch's FSDP2, TP and DTensor run
one process per rank). The ranks share an in-group ``torch.distributed``
process group (NCCL on the card, gloo on the CPU) over a ``DeviceMesh``
(``parallel.mesh``): FSDP2 shards the Llama over ``fsdp`` (and ``sp``),
tensor parallelism splits its heads and FFN over ``tp``, and ring or
Ulysses attention splits the sequence over ``sp``. Fault tolerance runs
across replica groups: every rank has its own ``Manager`` at its group
rank (group rank 0 leads, and its store's address reaches the others over
the in-group group), its own cross-group ``ProcessGroupHost`` carrying the
managed allreduce of its local gradient shards, and its own heal, from
the same rank of a healthy group, over HTTP or, with ``--transport pg``, a
recovery process group of its own into its live local shards of the
parameters and AdamW's moments.

The step is the reference's: quorum, loss and gradients under per-layer
full remat, the allreduce of the local gradient shards (unquantized, as
the reference's), the commit vote, then ``AdamW(lr, weight_decay=0.1)``.
``--diloco`` trains semi-synchronously instead: inner AdamW steps inside
the group, and ``local_sgd.DiLoCo`` over the local shards on a
synchronous quorum. Every rank draws the whole batch from
``np.random.RandomState(replica_id)``, as the reference does, and keeps
its slice.

A two-group demo (the lighthouse CLI and each group's rank processes as
fresh interpreters; every rank of group 1 is SIGKILLed once it printed its
``step=N`` line, the group restarts and heals rank by rank; exits 1 unless
it healed and both groups end with the same model)::

    python -m torchft_tpu_torch.examples.train_llama_hsdp --demo --device cpu

On the CPU the demo's groups are ``--fsdp 2`` unless the layout flags say
otherwise (``--tp 2``, ``--sp 2 --attention ulysses``, ...); on the card
each group is one rank (one card holds one NCCL rank). By hand, one group
of four ranks::

    python -m torchft_tpu_torch.lighthouse --bind 127.0.0.1:29510 --min-replicas 2 &
    TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=0 torchrun --nproc-per-node 4 \\
        -m torchft_tpu_torch.examples.train_llama_hsdp --fsdp 2 --tp 2

Under the supervising launcher (``torchft_tpu_torch.launcher``: it sets
each rank's variables and restarts a group that died), with durable
checkpoints every 3 committed steps and the pod aggregator in front of the
lighthouse::

    TORCHFT_LIGHTHOUSE_AGGREGATOR=127.0.0.1:29520 python -m torchft_tpu_torch.launcher \
        --lighthouse 127.0.0.1:29510 --replica-groups 2 --workers-per-replica 2 \
        --max-restarts 2 -m torchft_tpu_torch.examples.train_llama_hsdp -- \
        --device cpu --config debug --fsdp 2 --ckpt-dir /tmp/ckpt --ckpt-every 3

``--ckpt-dir`` keeps durable (tier-2) checkpoints of each group under
``replica_<id>/`` (``checkpointing.DurableCheckpointer``, on
``torch.distributed.checkpoint``; every rank writes its own shards): every
``--ckpt-every`` committed steps the whole registered state (parameters,
AdamW's moments, DiLoCo's fragments) with the Manager's step; a restarted
group restores its latest landed step in place before its first quorum,
so a whole-job outage resumes from there.

Each rank prints ``[replica i rank r] step=N inner=... loss=...
participants=... healed=... tok/s=... step_ms=...`` (then the step's split,
``storage_kept``, K1's launches so far, ``save_issue_s`` on a step that
saved, and ``via_aggregator`` / ``aggregator_failovers`` under an
aggregator), ``[replica i rank r] restored durable checkpoint step=N
sha256=...`` after a restore and ``[replica i rank r] durable checkpoint
landed step=N sha256=...`` when a save has landed (the ``state_digest`` of
the rank's restored or saved tensors), and ends with ``[replica i rank r]
done: {json}``: the sha256 of its local shards, on rank 0 the group's
digest of the gathered full tensors, its Manager's metrics and heal
timings, whether its local tensors kept their storage, the last save's
``save_issue_s`` / ``save_land_s``, ``restore_s``, the checkpoint's
``ckpt_bytes``, and the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from torchft_tpu_torch import knobs
from torchft_tpu_torch.models.llama import CONFIGS
from torchft_tpu_torch.utils import local_shard, resolve_device, tensors_sha256

__all__ = ["demo", "main", "outage_demo", "parse_args", "train"]

# the repository's root: the demos' processes run `python -m` from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _init_group(device: torch.device, timeout: float) -> torch.device:
    """Join the replica group's in-group process group (torchrun's
    variables; a group of one needs none) and return this rank's device."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    backend = "gloo"
    if device.type == "cuda":
        backend = "nccl"
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world == 1 and "MASTER_PORT" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout))
    return device


def train(args: argparse.Namespace, init_state: Optional[Dict[str, torch.Tensor]] = None,
          keep_params: bool = False) -> Dict[str, Any]:
    """One rank of one replica group. ``init_state`` (a full state dict of
    the port's ``Llama``) replaces the seeded init; with ``keep_params``
    group rank 0's result carries the gathered full parameters."""
    from torchft_tpu_torch.checkpointing import DurableCheckpointer, PGTransport
    from torchft_tpu_torch.local_sgd import DiLoCo
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models.llama import Llama
    from torchft_tpu_torch.ops import attention as attn_ops
    from torchft_tpu_torch.ops import quantization
    from torchft_tpu_torch.parallel import (
        apply_hsdp,
        make_hsdp_mesh,
        make_ring_attention_fn,
        make_train_step,
        make_ulysses_attention_fn,
        shard_batch,
    )
    from torchft_tpu_torch.parallel.mesh import group_mean
    from torchft_tpu_torch.process_group import ProcessGroupHost

    fsdp, sp, tp = args.fsdp or 1, args.sp or 1, args.tp or 1
    device = _init_group(resolve_device(args.device), args.timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != fsdp * sp * tp:
        raise ValueError(f"a replica group of {world} ranks cannot hold fsdp={fsdp} x sp={sp} "
                         f"x tp={tp}")
    replica_id = int(os.environ.get("REPLICA_GROUP_ID", args.replica_id))
    lighthouse = knobs.env_raw("TORCHFT_LIGHTHOUSE", args.lighthouse)
    tag = f"[replica {replica_id} rank {rank}]"
    cfg = CONFIGS[args.config]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    # the in-group mesh: dp 1 (the replicated dim lives across groups, via
    # the Manager)
    mesh = make_hsdp_mesh(fsdp=fsdp, sp=sp, tp=tp, device_type=device.type)
    attention_fn = (make_ulysses_attention_fn(mesh) if args.attention == "ulysses"
                    else make_ring_attention_fn(mesh))
    # remat="full" (the reference's, :82): per-layer recompute
    model = Llama(cfg, device=device, attention_fn=attention_fn, remat=True)
    if init_state is not None:
        model.load_state_dict(init_state)
    else:
        # every rank of a group draws the same full weights; groups differ,
        # and the first quorum's init_sync heal makes them equal
        gen = torch.Generator(device=device)
        gen.manual_seed(replica_id)
        model.init_weights(gen)
    apply_hsdp(model, mesh)
    params = dict(model.named_parameters())
    optimizer = torch.optim.AdamW(params.values(), lr=args.lr, weight_decay=0.1)
    # AdamW's state as its first step would create it, zero: every heal
    # carries the same tree
    for p in params.values():
        optimizer.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                                  exp_avg_sq=torch.zeros_like(p))

    def local_params() -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {n: local_shard(p) for n, p in params.items()}

    def local_state() -> Dict[str, Any]:
        # this rank's shards, fresh views of the live storage: a PG heal
        # lands in them in place
        with torch.no_grad():
            opt = {n: {"exp_avg": local_shard(optimizer.state[p]["exp_avg"]),
                       "exp_avg_sq": local_shard(optimizer.state[p]["exp_avg_sq"]),
                       "step": optimizer.state[p]["step"]} for n, p in params.items()}
            return {"params": local_params(), "opt_state": opt}

    def load_state(sd: Dict[str, Any]) -> None:
        live = local_state()
        with torch.no_grad():
            for n in params:
                pairs = [(live["params"][n], sd["params"][n])]
                pairs += [(live["opt_state"][n][k], sd["opt_state"][n][k])
                          for k in ("exp_avg", "exp_avg_sq", "step")]
                for dst, src in pairs:
                    if dst.data_ptr() != src.data_ptr():  # not landed in place
                        dst.copy_(src)

    def storage() -> List[int]:
        state = local_state()
        leaves = [*state["params"].values(),
                  *(t for st in state["opt_state"].values() for t in st.values())]
        return [t.data_ptr() for t in leaves]

    # tier-2 durable checkpoints (tier 1 is the live heal), each rank its
    # own shards
    ckpt = None
    if args.ckpt_dir:
        def landed(rec: Dict[str, Any]) -> None:
            print(f"{tag} durable checkpoint landed step={rec['step']} sha256={rec['sha256']} "
                  f"bytes={rec['bytes']} issue_s={rec['issue_s']:.3f} land_s={rec['land_s']:.3f} "
                  f"write_s={rec['write_s']:.3f} digest_s={rec['digest_s']:.3f}", flush=True)

        ckpt = DurableCheckpointer(os.path.join(args.ckpt_dir, f"replica_{replica_id}"),
                                   save_interval_steps=args.ckpt_every, digest=True,
                                   on_saved=landed)

    transport = recovery_pg = None
    manager: Optional[Manager] = None
    if args.transport == "pg":
        # its own PG: one generation carries p2p or collective traffic
        recovery_pg = ProcessGroupHost(timeout=args.timeout)
        transport = PGTransport(recovery_pg, timeout=args.timeout,
                                state_dict_template=lambda: manager.state_dict_template())

    def make_manager(store_addr: Optional[str]) -> Manager:
        return Manager(
            pg=ProcessGroupHost(timeout=args.timeout),
            load_state_dict=load_state,
            state_dict=local_state,
            min_replica_size=args.min_replica_size,
            use_async_quorum=not args.diloco,  # DiLoCo needs the sync quorum
            replica_id=f"llama_hsdp_{replica_id}",
            lighthouse_addr=lighthouse,
            timeout=args.timeout,
            checkpoint_transport=transport,
            store_addr=store_addr,
            group_rank=rank,
            group_world_size=world,
        )

    # group rank 0 leads: its store's address reaches the others in-group
    box: List[Optional[str]] = [None]
    if rank == 0:
        manager = make_manager(None)
        box[0] = manager.store_addr
    dist.broadcast_object_list(box, src=0)
    if rank != 0:
        manager = make_manager(box[0])

    diloco = None
    if args.diloco:
        inner_step = make_train_step(model, optimizer, mesh)
        diloco = DiLoCo(
            manager, local_params(),
            lambda ps: torch.optim.SGD(ps, lr=args.outer_lr, momentum=0.9, nesterov=True),
            sync_every=args.sync_every, num_fragments=args.num_fragments,
            fragment_sync_delay=args.fragment_sync_delay, should_quantize=args.quantize,
            get_params=local_params,
        )

    storage0 = storage()
    # after every state fn is registered (DiLoCo's fragments above), so a
    # cold restart recovers the whole composite; then the quorum clock
    if ckpt is not None:
        restored = ckpt.restore(state_template=manager.user_state_dict())
        if restored is not None:
            user_sd, manager_sd, _ = restored
            manager.load_user_state_dict(user_sd)
            if manager_sd is not None:
                manager.load_state_dict(manager_sd)
            rec = ckpt.last_restore
            print(f"{tag} restored durable checkpoint step={manager.current_step()} "
                  f"sha256={rec['sha256']} bytes={rec['bytes']} "
                  f"restore_s={rec['restore_s']:.3f}", flush=True)

    def sync() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rng = np.random.RandomState(replica_id)
    B, S = args.batch_size, args.seq_len
    print(f"{tag} mesh fsdp={fsdp} sp={sp} tp={tp} attention={args.attention} "
          f"diloco={bool(diloco)} starting at step {manager.current_step()}", flush=True)
    losses: List[float] = []
    step_ms: List[float] = []
    t_start, tokens_done, inner = time.monotonic(), 0, 0
    per_cycle = diloco.sync_every if diloco is not None else 0
    trained = False
    last_send: Optional[float] = None  # the last heal served, printed once
    try:
        while (inner < args.steps) if diloco is not None else (manager.current_step() < args.steps):
            batch = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, S))).to(device)
            t0 = sync()
            split = ""
            if diloco is not None:
                # inner step: local gradients and AdamW, no cross-group traffic
                mean_loss = float(inner_step(batch, batch))
                diloco.step(local_params())
                healed = any(kind == "prepare" for kind, _ in diloco.last_step_syncs) \
                    and manager.last_quorum_healed()
                # committed quorums are the global clock (reference :240)
                inner = max(inner + 1, manager.current_step() * per_cycle)
                tokens_done += B * S
            else:
                manager.start_quorum()
                tokens, offset = shard_batch(batch, mesh)
                loss = model.loss(tokens, tokens, offset=offset)
                loss.backward()
                t1 = sync()
                grads = {n: local_shard(p.grad) for n, p in params.items()}
                reduced = manager.allreduce(grads).get_future().wait(timeout=args.timeout)
                t2 = sync()
                # quorum + forward + backward, and the cross-group allreduce
                split = f" compute_ms={(t1 - t0) * 1e3:.2f} allreduce_ms={(t2 - t1) * 1e3:.2f}"
                if not manager.should_commit():
                    optimizer.zero_grad()
                    continue
                with torch.no_grad():
                    for n, p in params.items():
                        local_shard(p.grad).copy_(reduced[n])
                optimizer.step()
                optimizer.zero_grad()
                healed = manager.last_quorum_healed()
                tokens_done += B * S * manager.num_participants()
                inner += 1
                mean_loss = float(group_mean(loss.detach()))
            if ckpt is not None:
                # lazy: the composite is built only on the interval
                t_save = time.perf_counter()
                if ckpt.maybe_save(manager.current_step(), manager.user_state_dict,
                                   manager=manager):
                    split += f" save_issue_s={time.perf_counter() - t_save:.3f}"
            step_ms.append((sync() - t0) * 1e3)
            losses.append(mean_loss)
            if inner % args.log_every == 0:
                dt = time.monotonic() - t_start
                timings = manager.timings()
                if healed:
                    split += (f" heal_recv_s={timings.get('heal_recv_s', float('nan')):.3f} "
                              f"heal_chunks={timings.get('heal_chunks', 0):.0f} "
                              f"heal_mb_per_s={timings.get('heal_mb_per_s', float('nan')):.1f}")
                if timings.get("heal_send_s") not in (None, last_send):
                    last_send = timings["heal_send_s"]
                    split += f" heal_send_s={last_send:.3f}"
                if "via_aggregator" in timings:
                    split += (f" via_aggregator={timings['via_aggregator']:.0f} "
                              f"aggregator_failovers={timings['aggregator_failovers']:.0f}")
                k1 = "/".join(str(attn_ops.LAUNCHES[f"splash_{k}"]) for k in ("fwd", "dq", "dkv"))
                print(f"{tag} step={manager.current_step()} inner={inner} loss={mean_loss:.4f} "
                      f"participants={manager.num_participants()} healed={healed} "
                      f"tok/s={tokens_done / max(dt, 1e-6):.0f} step_ms={step_ms[-1]:.2f}{split} "
                      f"storage_kept={storage() == storage0} splash={k1}", flush=True)
        trained = True
    finally:
        try:
            if diloco is not None:
                # finish a sync between its prepare and its perform, so peers
                # are not left waiting on an abandoned commit round
                diloco.flush(local_params())
        except Exception as e:  # noqa: BLE001 - must not mask the original error
            print(f"{tag} flush failed during teardown: {e}", flush=True)
        finally:
            try:
                if ckpt is not None:
                    ckpt.close()  # the save in flight lands first
            finally:
                if trained:
                    # group rank 0's manager server answers every rank's
                    # last vote before it stops
                    dist.barrier()
                manager.shutdown(wait=False)
                if recovery_pg is not None:
                    recovery_pg.shutdown()  # the transport leaves its PG alone
    # the group's digest: every full tensor, gathered in name order
    full = {}
    digest = None
    with torch.no_grad():
        gathered = {n: p.full_tensor() for n, p in sorted(params.items())}
    if rank == 0:
        digest = tensors_sha256(gathered.values())
        if keep_params:
            full = {n: t.cpu() for n, t in gathered.items()}
    del gathered
    done = {
        "step": manager.current_step(),
        "inner": inner,
        "local_sha256": tensors_sha256(t for _, t in sorted(local_params().items())),
        "group_sha256": digest,
        "storage_kept": storage() == storage0,
        "save_issue_s": ckpt.saved[-1]["issue_s"] if ckpt is not None and ckpt.saved else None,
        "save_land_s": ckpt.saved[-1]["land_s"] if ckpt is not None and ckpt.saved else None,
        "restore_s": (ckpt.last_restore["restore_s"]
                      if ckpt is not None and ckpt.last_restore else None),
        "ckpt_bytes": ckpt.saved[-1]["bytes"] if ckpt is not None and ckpt.saved else None,
        "step_ms_median": statistics.median(step_ms) if step_ms else None,
        "attention": attn_ops.LAST_DISPATCH,
        "metrics": manager.metrics(),
        "timings": manager.timings(),
        "launches": {**quantization.LAUNCHES, **attn_ops.LAUNCHES},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
        "losses": losses,
    }
    if diloco is not None:
        done["fragments_sha256"] = tensors_sha256(diloco.state_tensors())
    print(f"{tag} done: {json.dumps(done)}", flush=True)
    dist.destroy_process_group()
    return {**done, "params": full}


# the demos' lighthouse: quick quorums, and a dead group noticed in 2 s
_LIGHTHOUSE_ARGV = ["--join-timeout-ms", "500", "--quorum-tick-ms", "50",
                    "--heartbeat-timeout-ms", "2000"]


def _group_argv(args: argparse.Namespace) -> "tuple[List[str], int]":
    """A demo's worker arguments and ranks a group: ``fsdp * sp * tp``,
    by default 2 ranks a group on the CPU and one on the card (one card
    holds one NCCL rank)."""
    layout = (args.fsdp, args.sp, args.tp)
    if layout == (None, None, None):
        layout = (2, 1, 1) if args.device == "cpu" else (1, 1, 1)
    fsdp, sp, tp = (x or 1 for x in layout)
    argv = ["--config", args.config, "--layers", str(args.layers), "--steps", str(args.steps),
            "--batch-size", str(args.batch_size), "--seq-len", str(args.seq_len), "--lr",
            str(args.lr),
            "--fsdp", str(fsdp), "--sp", str(sp), "--tp", str(tp), "--attention", args.attention,
            "--transport", args.transport, "--timeout", str(args.timeout),
            "--min-replica-size", str(args.min_replica_size), "--device", args.device]
    if args.diloco:
        argv += ["--diloco", "--sync-every", str(args.sync_every), "--num-fragments",
                 str(args.num_fragments), "--fragment-sync-delay", str(args.fragment_sync_delay),
                 "--outer-lr", str(args.outer_lr)] + (["--quantize"] if args.quantize else [])
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every)]
    return argv, fsdp * sp * tp


def demo(args: argparse.Namespace) -> None:
    """Start the lighthouse CLI and ``--replicas`` groups of ``fsdp * sp *
    tp`` rank processes, SIGKILL every rank of the last group once it
    printed its ``step=--kill-at-step`` line (the reference kills after a
    time, which a fast run can outlast), restart the group, and exit with the OR of every exit code,
    or 1 unless every rank of the restarted group healed and every group's
    digest is the same (under DiLoCo: each rank's fragment state). The
    lighthouse wants every group in a quorum (the reference's demo wants
    one), so the survivors wait for the restart and it always rejoins
    through a heal."""
    from torchft_tpu_torch.examples.train_ddp import Fleet

    argv, ranks = _group_argv(args)
    fleet = Fleet(argv, _LIGHTHOUSE_ARGV + ["--min-replicas", str(args.replicas)],
                  echo=True, module="torchft_tpu_torch.examples.train_llama_hsdp", ranks=ranks)
    rc = 0
    try:
        print(f"lighthouse at {fleet.addr}", flush=True)
        for rid in range(args.replicas):
            fleet.spawn(rid)
        victim = args.replicas - 1
        fleet.wait_line(victim, f"] step={args.kill_at_step} ", args.timeout * 10)
        print(f"--- killing every rank of replica {victim} ---", flush=True)
        fleet.kill(victim)
        print(f"--- restarting replica {victim} ---", flush=True)
        fleet.spawn(victim)
        for code in fleet.wait(timeout=args.timeout * 10).values():
            rc |= code
        if rc == 0:
            healed = all(fleet.done(victim, r)["metrics"]["heals"] >= 1 for r in range(ranks))
            # DiLoCo groups agree on the fragments' state (each rank's
            # shards), not on parameters trained on since the last sync
            digests = [{fleet.done(rid, r)["fragments_sha256"] for rid in range(args.replicas)}
                       for r in range(ranks)] if args.diloco else \
                [{fleet.done(rid, 0)["group_sha256"] for rid in range(args.replicas)}]
            print(f"heal of every rank of replica {victim}: {healed}; digests {digests}",
                  flush=True)
            if not healed or any(len(d) != 1 for d in digests):
                rc = 1
    finally:
        fleet.close()
    print("demo finished rc=", rc, flush=True)
    sys.exit(rc)


# where a worker's or a manager server's line starts
_LINE_START = re.compile(r"(?<=.)(?=\[replica \d+ rank \d+\] |\[manager )")


class _Transcript:
    """The outage demo's processes, each in a session of its own, their
    lines gathered (``name: line``) with their arrival times."""

    def __init__(self, echo: bool) -> None:
        self.lines: List[str] = []
        self.times: List[float] = []
        self.procs: Dict[str, Any] = {}
        self._cond = threading.Condition()
        self._echo = echo
        self._t0 = time.monotonic()

    def start(self, name: str, argv: List[str], env: Dict[str, str]):
        proc = subprocess.Popen(argv, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)

        def pump() -> None:
            for line in proc.stdout:
                # the workers share the launcher's stdout: a line another
                # process wrote into the middle of one is a line of its own
                for part in _LINE_START.split(line.rstrip("\n")):
                    with self._cond:
                        self.lines.append(f"{name}: {part}")
                        self.times.append(time.monotonic())
                        self._cond.notify_all()
                        if self._echo:
                            print(f"[{self.times[-1] - self._t0:8.2f}] {self.lines[-1]}",
                                  flush=True)

        threading.Thread(target=pump, daemon=True, name=f"outage_{name}").start()
        self.procs[name] = proc
        return proc

    def wait_for(self, pred, what: str, timeout: float, start: int = 0):
        """The first truthy ``pred(lines[start:])``; TimeoutError after
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                got = pred(self.lines[start:])
                if got:
                    return got
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"outage demo: no {what} within {timeout} s")
                self._cond.wait(left)

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _worker_line(line: str) -> Optional[tuple]:
    """``(group, rank, text)`` of a worker's line in the launcher's output."""
    m = re.match(r"launcher: \[replica (\d+) rank (\d+)\] (.*)$", line)
    return (int(m.group(1)), int(m.group(2)), m.group(3)) if m else None


# a step line's fields the outage demo's summary keeps (group rank 0's)
_STEP_FIELDS = ("step", "participants", "healed", "step_ms", "compute_ms", "allreduce_ms",
                "save_issue_s", "heal_recv_s", "heal_chunks", "heal_mb_per_s", "heal_send_s",
                "via_aggregator", "aggregator_failovers", "storage_kept")


def _field(text: str, name: str) -> Optional[str]:
    m = re.search(rf"(?:^|\s){name}=(\S+)", text)
    return m.group(1) if m else None


def _quorum_done(lines: List[str]) -> bool:
    """Both groups' leaders finished a quorum round (their manager servers'
    log lines)."""
    return all(any(f"[manager llama_hsdp_{g}:" in ln and "Finished quorum for group_rank 0" in ln
                   for ln in lines) for g in (0, 1))


def outage_demo(args: argparse.Namespace) -> None:
    """A whole-job outage under the supervising launcher, driven as an
    operator would: the lighthouse CLI, the pod aggregator's CLI in front
    of it (every worker has ``TORCHFT_LIGHTHOUSE_AGGREGATOR``), and
    ``python -m torchft_tpu_torch.launcher --replica-groups 2
    --max-restarts 2`` over two groups of this trainer with durable
    checkpoints every ``--ckpt-every`` steps under ``--ckpt-dir``. The
    punisher kills group 1 once it printed its ``--kill-at-step`` line (the
    launcher restarts it and it heals from group 0), then every group once
    both landed their step ``--ckpt-every`` checkpoint (the launcher
    restarts both, and each restores that step); after the first commit
    that follows, the aggregator gets SIGTERM and the Managers fail over to
    the lighthouse. The outage and the aggregator's death strike just
    after a quorum round finished, between rounds. A save waits for the
    one before it to land, so with ``--steps`` at least ``2 *
    --ckpt-every + 1`` the outage always finds both groups training. Exits
    1 unless the launcher returned 0 with restarts [1, 2], group 1 healed
    with its storage kept, every rank of both groups restored the newest
    step it landed before the outage with the digest it landed, the
    groups' final digests agree, the steps went through the aggregator
    before its death and the Managers failed over after it without a
    failed commit, and, on the card, K1's three kernels ran in every
    incarnation. Its last lines
    are ``outage demo summary: {json}`` and ``demo finished rc= N``."""
    from torchft_tpu_torch.examples import punisher

    if not args.ckpt_dir or args.diloco:
        raise ValueError("--outage-demo needs --ckpt-dir, and runs the per-step DDP loop")
    argv, ranks = _group_argv(args)
    every, deadline_s = args.ckpt_every, args.timeout * 5
    py = sys.executable
    tr = _Transcript(echo=True)
    summary: Dict[str, Any] = {}
    failures: List[str] = []
    try:
        tr.start("lighthouse", [py, "-m", "torchft_tpu_torch.lighthouse", "--bind",
                                "127.0.0.1:0", "--min-replicas", "2", *_LIGHTHOUSE_ARGV],
                 dict(os.environ))

        def listening(prefix: str):
            def pred(lines: List[str]):
                hit = next((ln for ln in lines if f"{prefix} listening at " in ln), None)
                return hit.split(" listening at ", 1)[1].split()[0] if hit else None
            return pred

        lh = tr.wait_for(listening("lighthouse"), "lighthouse address", 60)
        agg = tr.start("aggregator", [py, "-m", "torchft_tpu_torch.aggregator", "--root", lh,
                                      "--bind", "127.0.0.1:0", "--agg-id", "pod0", "--tick-ms",
                                      "50", "--heartbeat-timeout-ms", "2000"], dict(os.environ))
        agg_addr = tr.wait_for(listening("aggregator"), "aggregator address", 60)
        print(f"lighthouse at {lh}, aggregator at {agg_addr}", flush=True)
        # buffered workers: print() writes a line and its newline at once
        env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
        env["TORCHFT_LIGHTHOUSE_AGGREGATOR"] = agg_addr
        launcher = tr.start("launcher", [
            py, "-m", "torchft_tpu_torch.launcher", "--lighthouse", lh, "--replica-groups", "2",
            "--workers-per-replica", str(ranks), "--max-restarts", "2",
            "-m", "torchft_tpu_torch.examples.train_llama_hsdp", "--", *argv,
        ], env)

        def seen(prefix: str, groups=(0, 1)):
            """Per group, the first rank-0 line after ``start`` that starts
            with ``prefix``."""
            def pred(lines: List[str]):
                hits = {}
                for ln in lines:
                    w = _worker_line(ln)
                    if w and w[1] == 0 and w[0] in groups and w[0] not in hits \
                            and w[2].startswith(prefix):
                        hits[w[0]] = w[2]
                return hits if len(hits) == len(groups) else None
            return pred

        tr.wait_for(seen(f"step={args.kill_at_step} ", groups=(1,)),
                    f"group 1 step {args.kill_at_step}", deadline_s)
        victims = [r for r in punisher.list_replicas(lh) if r.startswith("llama_hsdp_1:")]
        print(f"--- punisher: kill_one {victims} ---", flush=True)
        for victim in victims:
            punisher.kill_one(lh, victim)

        def running(lines: List[str]) -> None:
            """The outage needs every group still training."""
            for ln in lines:
                w = _worker_line(ln)
                if w and w[2].startswith("done: "):
                    raise RuntimeError(f"outage demo: group {w[0]} finished before the outage "
                                       f"(its step {every} save landed after its last step; "
                                       f"--steps {args.steps} is too few)")

        def landed_all(lines: List[str]):
            running(lines)
            got = {}
            for ln in lines:
                w = _worker_line(ln)
                if w and w[2].startswith(f"durable checkpoint landed step={every} "):
                    got[(w[0], w[1])] = w[2]
            return got if len(got) == 2 * ranks else None

        tr.wait_for(landed_all, f"landed step {every} on every rank", deadline_s)
        # the outage strikes between quorum rounds: a leader killed while its
        # request waits in the aggregator would leave that request pending
        # there, and the root could join it to the restarted groups' quorum
        tr.wait_for(lambda lines: running(lines) or _quorum_done(lines), "the next quorum",
                    deadline_s, start=len(tr.lines))
        mark, t_outage = len(tr.lines), time.monotonic()
        # each rank's newest landed step when the outage strikes
        landed = {}
        for ln in tr.lines[:mark]:
            w = _worker_line(ln)
            if w and w[2].startswith("durable checkpoint landed step="):
                landed[(w[0], w[1])] = w[2]
        print("--- punisher: kill_all (a whole-job outage) ---", flush=True)
        punisher.kill_all(lh)

        def after(needle: str):
            def pred(lines: List[str]):
                got = {}
                for ln in lines:
                    w = _worker_line(ln)
                    if w and needle in w[2] and (w[0], w[1]) not in got:
                        got[(w[0], w[1])] = w[2]
                return got if len(got) == 2 * ranks else None
            return pred

        restored = tr.wait_for(after("restored durable checkpoint "), "restores", deadline_s,
                               start=mark)
        tr.wait_for(seen("step="), "the first commit after the outage", deadline_s, start=mark)
        with tr._cond:
            firsts = []
            for g in (0, 1):
                firsts.append(next(i for i in range(mark, len(tr.lines))
                                   if (w := _worker_line(tr.lines[i])) and w[:2] == (g, 0)
                                   and w[2].startswith("step=")))
            summary["outage_to_first_commit_s"] = max(tr.times[i] for i in firsts) - t_outage
        # the aggregator, too, dies between rounds; the next one fails over
        # to the lighthouse
        tr.wait_for(_quorum_done, "the next quorum", deadline_s, start=max(firsts) + 1)
        agg_mark = len(tr.lines)
        print("--- SIGTERM to the aggregator ---", flush=True)
        agg.send_signal(signal.SIGTERM)
        summary["aggregator_rc"] = agg.wait(timeout=30)
        summary["launcher_rc"] = launcher.wait(timeout=deadline_s)
    finally:
        tr.close()

    lines = tr.lines
    restarts = {g: sum(1 for ln in lines if f"replica group {g} died" in ln and "restart" in ln
                       and "out of restarts" not in ln) for g in (0, 1)}
    summary["restarts"] = restarts
    # every worker's incarnations, in order: each begins at its mesh line
    incs: Dict[tuple, List[List[tuple]]] = {}
    for i, ln in enumerate(lines):
        w = _worker_line(ln)
        if w is None:
            continue
        key = (w[0], w[1])
        if w[2].startswith("mesh ") or key not in incs:
            incs.setdefault(key, []).append([])
        incs[key][-1].append((i, w[2]))
    want_incs = {0: 2, 1: 3}
    for (g, r), runs in sorted(incs.items()):
        if len(runs) != want_incs[g]:
            failures.append(f"group {g} rank {r}: {len(runs)} incarnations, not {want_incs[g]}")
    if summary["launcher_rc"] != 0 or restarts != {0: 1, 1: 2}:
        failures.append(f"launcher rc {summary['launcher_rc']}, restarts {restarts}")
    if summary["aggregator_rc"] != 0:
        failures.append(f"the aggregator exited {summary['aggregator_rc']} on SIGTERM")

    def steps_of(run):
        return [(i, t) for i, t in run if t.startswith("step=")]

    done, launches, step_lines = {}, {}, {}
    for (g, r), runs in sorted(incs.items()):
        for k, run in enumerate(runs):
            st = steps_of(run)
            if st and _field(st[-1][1], "splash"):
                launches[f"group {g} rank {r} incarnation {k}"] = [
                    int(x) for x in _field(st[-1][1], "splash").split("/")]
            if r == 0:
                step_lines[f"group {g} incarnation {k}"] = [
                    {f: _field(t, f) for f in _STEP_FIELDS if _field(t, f) is not None}
                    for _, t in st]
            if k == len(runs) - 1:
                d = next((t for _, t in run if t.startswith("done: ")), None)
                if d is None:
                    failures.append(f"group {g} rank {r}: no done line")
                else:
                    done[(g, r)] = json.loads(d[len("done: "):])
        if len(runs) >= 2 and g == 1:
            healed = [t for _, t in steps_of(runs[1])]
            if not any(_field(t, "healed") == "True" for t in healed) or \
                    not all(_field(t, "storage_kept") == "True" for t in healed):
                failures.append(f"group 1 rank {r} did not heal in place after the kill")
    summary["launches"] = launches
    if args.device == "cuda":
        if any(min(v) == 0 for v in launches.values()):
            failures.append(f"K1 did not launch in every incarnation: {launches}")
        if any(d["attention"] != "splash" for d in done.values()):
            failures.append("attention did not dispatch to splash")
    summary["landed"] = {f"{g}/{r}": {k: _field(t, k) for k in ("step", "sha256", "bytes",
                                                                 "issue_s", "land_s", "write_s",
                                                                 "digest_s")}
                         for (g, r), t in sorted(landed.items())}
    summary["restored"] = {f"{g}/{r}": {k: _field(t, k) for k in ("step", "sha256", "bytes",
                                                                   "restore_s")}
                           for (g, r), t in sorted(restored.items())}
    for key, rec in summary["restored"].items():
        want = summary["landed"][key]
        if (rec["step"], rec["sha256"]) != (want["step"], want["sha256"]):
            failures.append(f"group/rank {key} restored {rec}, landed {summary['landed'][key]}")
    digests = {d["group_sha256"] for (g, r), d in done.items() if r == 0}
    summary["group_sha256"] = sorted(digests)
    if len(digests) != 1:
        failures.append(f"the groups' final digests differ: {digests}")
    for (g, r), d in done.items():
        if d["step"] != args.steps or d["metrics"]["commit_failures"] or d["metrics"]["errors"]:
            failures.append(f"group {g} rank {r} ended at step {d['step']} with {d['metrics']}")
        if r == 0 and d["timings"].get("aggregator_failovers", 0) < 1:
            failures.append(f"group {g}: no aggregator failover after its death")
    via = [_field(w[2], "via_aggregator") for ln in lines[:agg_mark]
           if (w := _worker_line(ln)) and w[1] == 0 and w[2].startswith("step=")]
    if not via or any(v != "1" for v in via):
        failures.append(f"steps before the aggregator's death not through it: {via}")
    summary["step_lines"] = step_lines
    summary["done"] = {f"{g}/{r}": d for (g, r), d in sorted(done.items())}
    summary["failures"] = failures
    print(f"outage demo summary: {json.dumps(summary)}", flush=True)
    rc = 1 if failures else 0
    print("demo finished rc=", rc, flush=True)
    sys.exit(rc)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="tiny", choices=sorted(CONFIGS),
                        help="model config (CONFIGS key)")
    parser.add_argument("--layers", type=int, default=0,
                        help="cut the model to this many layers at its full width (0: the "
                             "config's), as the trainer's --layers")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--fsdp", type=int, default=None, help="default 1 (the demo: see above)")
    parser.add_argument("--sp", type=int, default=None, help="default 1")
    parser.add_argument("--tp", type=int, default=None, help="default 1")
    parser.add_argument("--attention", choices=["ring", "ulysses"], default="ring",
                        help="sequence-parallel strategy over sp: ring (no head-count limit) "
                             "or ulysses (all-to-all; sp must divide the per-rank head counts)")
    parser.add_argument("--min-replica-size", type=int, default=1)
    parser.add_argument("--transport", choices=["http", "pg"], default="http",
                        help="heal transport: http, or pg (a recovery process group, in place)")
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument("--diloco", action="store_true",
                        help="semi-sync across groups (DiLoCo) instead of the per-step allreduce")
    parser.add_argument("--sync-every", type=int, default=20)
    parser.add_argument("--num-fragments", type=int, default=2)
    parser.add_argument("--fragment-sync-delay", type=int, default=1)
    parser.add_argument("--outer-lr", type=float, default=0.7)
    parser.add_argument("--quantize", action="store_true",
                        help="fp8-compress the pseudogradient allreduce")
    parser.add_argument("--log-every", type=int, default=1)
    parser.add_argument("--ckpt-dir", default="",
                        help="directory of tier-2 durable checkpoints (a replica_<id>/ a group); "
                             "empty: none")
    parser.add_argument("--ckpt-every", type=int, default=100,
                        help="durable-checkpoint interval in committed steps")
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument("--lighthouse", type=str, default="127.0.0.1:29510")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--outage-demo", action="store_true",
                        help="a whole-job outage under the launcher, the aggregator and the "
                             "punisher (needs --ckpt-dir; see outage_demo)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--kill-at-step", type=int, default=3,
                        help="demo: kill the last group once it printed this step's line")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.outage_demo:
        outage_demo(args)
    elif args.demo:
        demo(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
