"""Shared CLI surface for the port's cluster launch paths (GKE + slurm):
the counterpart of ``examples/cluster/_common.py``.

One definition of the training/fault-tolerance knobs and of the reference
DiLoCo semi-sync config (torchft/examples/slurm/runner.py:23-60: sync_steps
20, 2 fragments, 1-step delay) so the two runners cannot drift apart.
"""

from __future__ import annotations

import argparse

__all__ = ["DILOCO_TRAINER_FLAGS", "TRAINER_MODULE", "add_training_args", "mesh_args"]

# every replica group runs the port's HSDP trainer, one rank a GPU
TRAINER_MODULE = "torchft_tpu_torch.examples.train_llama_hsdp"

# the reference semi-sync config — same Llama trainer, DiLoCo mode
DILOCO_TRAINER_FLAGS = [
    "--diloco",
    "--sync-every=20",
    "--num-fragments=2",
    "--fragment-sync-delay=1",
]


def add_training_args(p: argparse.ArgumentParser) -> None:
    """Args shared verbatim by every launch path."""
    p.add_argument("--replica-groups", type=int, default=4)
    p.add_argument("--min-replicas", type=int, default=2)
    p.add_argument("--model-config", default="llama3_8b")
    p.add_argument("--local-batch-size", type=int, default=2)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--semi-sync-method", choices=["none", "diloco"],
                   default="none")
    p.add_argument("--sp", type=int, default=1,
                   help="in-group sequence-parallel degree")
    p.add_argument("--tp", type=int, default=1,
                   help="in-group tensor-parallel degree")


def mesh_args(args: argparse.Namespace, gpus: int) -> "tuple[int, int, int]":
    """Resolve the in-group mesh, defaulting fsdp to fill the group's GPUs
    (the trainer's own default of 1x1x1 would leave all but one GPU idle).

    Raises ValueError when fsdp*sp*tp does not cover ``gpus``.
    """
    fsdp = args.fsdp if args.fsdp else max(1, gpus // (args.sp * args.tp))
    if fsdp * args.sp * args.tp != gpus:
        raise ValueError(
            f"mesh fsdp({fsdp})*sp({args.sp})*tp({args.tp}) must equal the "
            f"group's GPU count ({gpus})"
        )
    return fsdp, args.sp, args.tp
