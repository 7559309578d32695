"""Slurm launch path for the Llama-3-8B FT-HSDP target on GPU nodes: the
port's counterpart of ``examples/cluster/slurm_runner.py``.

Role-equivalent of the reference's slurm runner
(torchft/examples/slurm/runner.py:23-60): submit one scheduler job per
replica group plus the lighthouse, each carrying the framework's env
contract (``torchft_tpu_torch/launcher.py``: ``TORCHFT_LIGHTHOUSE``,
``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``, ``GROUP_RANK``,
``GROUP_WORLD_SIZE``). A replica group is one node: its job asks slurm
for ``--gpus-per-node`` GPUs and runs the port's HSDP trainer one rank a
GPU (``torchrun --standalone --nproc-per-node G -m
torchft_tpu_torch.examples.train_llama_hsdp``, NCCL inside the group),
from the directory that holds the package. The lighthouse job runs
``python -m torchft_tpu_torch.lighthouse``.

Dry-run friendly: ``--dry-run`` prints the sbatch scripts instead of
submitting, so the launch path is reviewable without a cluster:

    python -m torchft_tpu_torch.examples.cluster.slurm_runner --replica-groups 4 --dry-run
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional, Tuple

from torchft_tpu_torch.examples.cluster._common import (
    DILOCO_TRAINER_FLAGS,
    TRAINER_MODULE,
    add_training_args,
    mesh_args,
)

__all__ = ["build_scripts", "main"]

# the directory holding the package: every job starts there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

LIGHTHOUSE_SBATCH = """\
#!/bin/bash
#SBATCH --job-name=torchft-lighthouse
#SBATCH --nodes=1
#SBATCH --nodelist={lighthouse_host}
#SBATCH --output=lighthouse.log
#SBATCH --requeue
cd {root}
exec python -m torchft_tpu_torch.lighthouse \\
    --bind=0.0.0.0:{port} --min-replicas={min_replicas} \\
    --join-timeout-ms=60000 --quorum-tick-ms=100 --heartbeat-timeout-ms=5000
"""

REPLICA_SBATCH = """\
#!/bin/bash
#SBATCH --job-name=torchft-replica-{rid}
#SBATCH --nodes=1
#SBATCH --gpus-per-node={gpus}
#SBATCH --output=replica_{rid}_%j.log
#SBATCH --requeue
export TORCHFT_LIGHTHOUSE={lighthouse_host}:{port}
export REPLICA_GROUP_ID={rid}
export NUM_REPLICA_GROUPS={num_groups}
export GROUP_RANK=0
export GROUP_WORLD_SIZE=1
cd {root}
exec torchrun --standalone --nproc-per-node={gpus} -m {module} \\
    {config_arg}--batch-size={local_batch_size} --steps={steps} \\
    --fsdp={fsdp} --sp={sp} --tp={tp}{extra}
"""


def build_scripts(args: argparse.Namespace) -> List[Tuple[str, str]]:
    scripts = [
        (
            "lighthouse.sbatch",
            LIGHTHOUSE_SBATCH.format(
                # pin to the host every replica's TORCHFT_LIGHTHOUSE points
                # at; otherwise slurm may place the lighthouse elsewhere
                lighthouse_host=args.lighthouse_host,
                port=args.port,
                min_replicas=args.min_replicas,
                root=_ROOT,
            ),
        )
    ]
    config_arg = f"--config={args.model_config} "
    fsdp, sp, tp = mesh_args(args, args.gpus_per_node)
    extra = ""
    if args.semi_sync_method == "diloco":
        extra = " \\\n    " + " ".join(DILOCO_TRAINER_FLAGS)
    for rid in range(args.replica_groups):
        scripts.append(
            (
                f"replica_{rid}.sbatch",
                REPLICA_SBATCH.format(
                    rid=rid,
                    lighthouse_host=args.lighthouse_host,
                    port=args.port,
                    num_groups=args.replica_groups,
                    gpus=args.gpus_per_node,
                    root=_ROOT,
                    module=TRAINER_MODULE,
                    config_arg=config_arg,
                    local_batch_size=args.local_batch_size,
                    steps=args.steps,
                    fsdp=fsdp,
                    sp=sp,
                    tp=tp,
                    extra=extra,
                ),
            )
        )
    return scripts


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_training_args(p)
    p.add_argument(
        "--lighthouse-host", default=None,
        help="hostname running the lighthouse job (REQUIRED to submit: each "
             "sbatch job is its own allocation, so no in-script expansion "
             "can discover the lighthouse's node)",
    )
    p.add_argument("--port", type=int, default=29510)
    p.add_argument("--gpus-per-node", type=int, default=8,
                   help="GPUs per node (one replica group; the in-group mesh)")
    p.add_argument("--fsdp", type=int, default=0,
                   help="in-group ZeRO shard degree (0 = fill the node)")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    if args.lighthouse_host is None:
        if not args.dry_run:
            p.error("--lighthouse-host is required to submit")
        args.lighthouse_host = "LIGHTHOUSE_HOST"  # review placeholder

    for name, text in build_scripts(args):
        if args.dry_run:
            sys.stdout.write(f"# === {name} ===\n{text}\n")
        else:
            with open(name, "w") as f:
                f.write(text)
            subprocess.run(["sbatch", name], check=True)
            print(f"submitted {name}")


if __name__ == "__main__":
    main()
