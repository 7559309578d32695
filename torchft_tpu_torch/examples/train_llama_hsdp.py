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

Each rank prints ``[replica i rank r] step=N inner=... loss=...
participants=... tok/s=... step_ms=...`` and ends with ``[replica i rank
r] done: {json}``: the sha256 of its local shards, on rank 0 the group's
digest of the gathered full tensors, its Manager's metrics and heal
timings, whether its local tensors kept their storage, and the kernels'
launch counts. Durable checkpoints (``--ckpt-dir``) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from torchft_tpu_torch.models.llama import CONFIGS
from torchft_tpu_torch.utils import local_shard, resolve_device, tensors_sha256

__all__ = ["demo", "main", "parse_args", "train"]


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
    from torchft_tpu_torch.checkpointing import PGTransport
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

    if args.ckpt_dir:
        raise NotImplementedError(
            "durable checkpoints (--ckpt-dir) are not ported yet: ROADMAP.md queue 1 item 8")
    fsdp, sp, tp = args.fsdp or 1, args.sp or 1, args.tp or 1
    device = _init_group(resolve_device(args.device), args.timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != fsdp * sp * tp:
        raise ValueError(f"a replica group of {world} ranks cannot hold fsdp={fsdp} x sp={sp} "
                         f"x tp={tp}")
    replica_id = int(os.environ.get("REPLICA_GROUP_ID", args.replica_id))
    lighthouse = os.environ.get("TORCHFT_LIGHTHOUSE", args.lighthouse)
    tag = f"[replica {replica_id} rank {rank}]"
    cfg = CONFIGS[args.config]

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

    def sync() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rng = np.random.RandomState(replica_id)
    B, S = args.batch_size, args.seq_len
    print(f"{tag} mesh fsdp={fsdp} sp={sp} tp={tp} attention={args.attention} "
          f"diloco={bool(diloco)} starting at step {manager.current_step()}", flush=True)
    storage0 = storage()
    losses: List[float] = []
    step_ms: List[float] = []
    t_start, tokens_done, inner = time.monotonic(), 0, 0
    per_cycle = diloco.sync_every if diloco is not None else 0
    trained = False
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
            step_ms.append((sync() - t0) * 1e3)
            losses.append(mean_loss)
            if inner % args.log_every == 0:
                dt = time.monotonic() - t_start
                print(f"{tag} step={manager.current_step()} inner={inner} loss={mean_loss:.4f} "
                      f"participants={manager.num_participants()} healed={healed} "
                      f"tok/s={tokens_done / max(dt, 1e-6):.0f} step_ms={step_ms[-1]:.2f}{split}",
                      flush=True)
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
            if trained:
                # group rank 0's manager server answers every rank's last
                # vote before it stops
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
        "step_ms_median": statistics.median(step_ms) if step_ms else None,
        "attention": attn_ops.LAST_DISPATCH,
        "metrics": manager.metrics(),
        "timings": manager.timings(),
        "launches": {**quantization.LAUNCHES, **attn_ops.LAUNCHES},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    if diloco is not None:
        done["fragments_sha256"] = tensors_sha256(diloco.state_tensors())
    print(f"{tag} done: {json.dumps(done)}", flush=True)
    dist.destroy_process_group()
    return {**done, "losses": losses, "params": full}


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

    device = args.device
    layout = (args.fsdp, args.sp, args.tp)
    if layout == (None, None, None):
        # 2 ranks a group on the CPU; one card holds one NCCL rank
        layout = (2, 1, 1) if device == "cpu" else (1, 1, 1)
    fsdp, sp, tp = (x or 1 for x in layout)
    argv = ["--config", args.config, "--steps", str(args.steps), "--batch-size",
            str(args.batch_size), "--seq-len", str(args.seq_len), "--lr", str(args.lr),
            "--fsdp", str(fsdp), "--sp", str(sp), "--tp", str(tp), "--attention", args.attention,
            "--transport", args.transport, "--timeout", str(args.timeout),
            "--min-replica-size", str(args.min_replica_size), "--device", device]
    if args.diloco:
        argv += ["--diloco", "--sync-every", str(args.sync_every), "--num-fragments",
                 str(args.num_fragments), "--fragment-sync-delay", str(args.fragment_sync_delay),
                 "--outer-lr", str(args.outer_lr)] + (["--quantize"] if args.quantize else [])
    ranks = fsdp * sp * tp
    fleet = Fleet(argv, ["--min-replicas", str(args.replicas), "--join-timeout-ms", "500",
                         "--quorum-tick-ms", "50", "--heartbeat-timeout-ms", "2000"],
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


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="tiny", choices=sorted(CONFIGS),
                        help="model config (CONFIGS key)")
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
                        help="durable checkpoints: not ported yet (ROADMAP.md queue 1 item 8)")
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument("--lighthouse", type=str, default="127.0.0.1:29510")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--kill-at-step", type=int, default=3,
                        help="demo: kill the last group once it printed this step's line")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.demo:
        demo(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
