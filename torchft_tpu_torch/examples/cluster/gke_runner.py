"""GKE launch path for the Llama-3-8B FT-HSDP target on GPU nodes: the
port's counterpart of ``examples/cluster/gke_runner.py``.

Role-equivalent of the reference's slurm runner
(torchft/examples/slurm/runner.py:23-60: one scheduler job per replica
group running the Llama-3-8B config with the fault-tolerance env). This
generates (and optionally `kubectl apply`s) the manifests:

- 1 lighthouse Deployment + Service (stable DNS name for
  ``TORCHFT_LIGHTHOUSE``), running ``python -m torchft_tpu_torch.lighthouse``
- N replica-group Jobs, each one pod on one GPU node: it requests
  ``--gpus-per-pod`` GPUs (``nvidia.com/gpu``) on a node of the
  ``--accelerator`` type (``cloud.google.com/gke-accelerator``, H100 80GB
  by default) and runs the port's HSDP trainer one rank a GPU
  (``torchrun --standalone --nproc-per-node G -m
  torchft_tpu_torch.examples.train_llama_hsdp``, NCCL inside the group,
  ``/dev/shm`` a memory volume for it), with the framework's env contract
  (REPLICA_GROUP_ID / NUM_REPLICA_GROUPS / TORCHFT_LIGHTHOUSE —
  ``torchft_tpu_torch/launcher.py``). Jobs restart on failure
  (``backoffLimit``); a restarted group rejoins the quorum and live-heals
  from a peer, so no coordinated restart is needed.

No cluster is required to generate or inspect the manifests:

    python -m torchft_tpu_torch.examples.cluster.gke_runner --replica-groups 4 \\
        --gpus-per-pod 8 --out jobs.yaml
    kubectl apply -f jobs.yaml   # on a real cluster

Mirrored training config (reference runner.py:23-60): llama3_8b,
local_batch_size 2, steps 10000, optional DiLoCo semi-sync
(sync_every 20, 2 fragments).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

from torchft_tpu_torch.examples.cluster._common import (
    DILOCO_TRAINER_FLAGS,
    TRAINER_MODULE,
    add_training_args,
    mesh_args,
)

__all__ = ["build_manifests", "main"]

LIGHTHOUSE_PORT = 29510

LIGHTHOUSE_MANIFEST = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: torchft-lighthouse
  labels: {{app: torchft-lighthouse}}
spec:
  replicas: 1
  selector:
    matchLabels: {{app: torchft-lighthouse}}
  template:
    metadata:
      labels: {{app: torchft-lighthouse}}
    spec:
      containers:
      - name: lighthouse
        image: {image}
        command: ["python", "-m", "torchft_tpu_torch.lighthouse"]
        args:
        - "--bind=0.0.0.0:{port}"
        - "--min-replicas={min_replicas}"
        - "--join-timeout-ms=60000"
        - "--quorum-tick-ms=100"
        - "--heartbeat-timeout-ms=5000"
        ports:
        - containerPort: {port}
---
apiVersion: v1
kind: Service
metadata:
  name: torchft-lighthouse
spec:
  selector: {{app: torchft-lighthouse}}
  ports:
  - port: {port}
    targetPort: {port}
"""

REPLICA_JOB_MANIFEST = """\
apiVersion: batch/v1
kind: Job
metadata:
  name: torchft-replica-{rid}
  labels: {{app: torchft-replica, replica-group: "{rid}"}}
spec:
  # a dead replica group is rescheduled and live-heals from a peer on
  # rejoin; unlimited-ish retries are the FT design, not a hack
  backoffLimit: 1000
  template:
    metadata:
      labels: {{app: torchft-replica, replica-group: "{rid}"}}
    spec:
      restartPolicy: OnFailure
      nodeSelector:
        cloud.google.com/gke-accelerator: {accelerator}
      containers:
      - name: trainer
        image: {image}
        command: ["torchrun", "--standalone", "--nproc-per-node={gpus}", "-m", "{module}"]
        args:
        - "--batch-size={local_batch_size}"
        - "--steps={steps}"{extra_args}
        env:
        - name: TORCHFT_LIGHTHOUSE
          value: "torchft-lighthouse:{port}"
        - name: REPLICA_GROUP_ID
          value: "{rid}"
        - name: NUM_REPLICA_GROUPS
          value: "{num_groups}"
        - name: GROUP_RANK
          value: "0"
        - name: GROUP_WORLD_SIZE
          value: "1"
        resources:
          requests: {{"nvidia.com/gpu": {gpus}}}
          limits: {{"nvidia.com/gpu": {gpus}}}
        volumeMounts:
        - name: dshm
          mountPath: /dev/shm
      volumes:
      - name: dshm
        emptyDir: {{medium: Memory}}
"""


def build_manifests(args: argparse.Namespace) -> str:
    docs = [
        LIGHTHOUSE_MANIFEST.format(
            image=args.image,
            port=LIGHTHOUSE_PORT,
            min_replicas=args.min_replicas,
        )
    ]
    # one pod a group: its GPUs are one node's (GKE GPU nodes hold 8)
    if not 1 <= args.gpus_per_pod <= 8:
        raise ValueError(f"--gpus-per-pod {args.gpus_per_pod}: a pod's GPUs are one "
                         "node's, 1 to 8")
    fsdp, sp, tp = mesh_args(args, args.gpus_per_pod)
    extra = '\n        - "--config={0}"'.format(args.model_config)
    extra += (
        f'\n        - "--fsdp={fsdp}"'
        f'\n        - "--sp={sp}"'
        f'\n        - "--tp={tp}"'
    )
    if args.semi_sync_method == "diloco":
        extra += "".join(
            f'\n        - "{flag}"' for flag in DILOCO_TRAINER_FLAGS
        )
    for rid in range(args.replica_groups):
        docs.append(
            REPLICA_JOB_MANIFEST.format(
                rid=rid,
                image=args.image,
                accelerator=args.accelerator,
                gpus=args.gpus_per_pod,
                module=TRAINER_MODULE,
                local_batch_size=args.local_batch_size,
                steps=args.steps,
                num_groups=args.replica_groups,
                port=LIGHTHOUSE_PORT,
                extra_args=extra,
            )
        )
    return "---\n".join(docs)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_training_args(p)
    p.add_argument("--image", default="gcr.io/PROJECT/torchft-tpu-torch:latest")
    p.add_argument("--accelerator", default="nvidia-h100-80gb",
                   help="the GPU nodes' cloud.google.com/gke-accelerator label")
    p.add_argument("--gpus-per-pod", type=int, default=8,
                   help="GPUs requested per replica-group pod (one node's, "
                        "1 to 8): the in-group mesh, one rank a GPU")
    p.add_argument("--fsdp", type=int, default=0,
                   help="in-group ZeRO shard degree (0 = fill the pod's GPUs)")
    p.add_argument("--out", default="-", help="output file ('-' = stdout)")
    p.add_argument("--apply", action="store_true",
                   help="kubectl apply the generated manifests")
    args = p.parse_args(argv)

    yaml_text = build_manifests(args)
    if args.out == "-":
        sys.stdout.write(yaml_text)
    else:
        with open(args.out, "w") as f:
            f.write(yaml_text)
        print(f"wrote {args.out}")
    if args.apply:
        subprocess.run(["kubectl", "apply", "-f", "-"],
                       input=yaml_text.encode(), check=True)


if __name__ == "__main__":
    main()
