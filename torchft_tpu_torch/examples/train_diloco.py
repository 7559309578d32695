"""Streaming DiLoCo training example: the port's counterpart of
``examples/train_diloco.py``.

Each replica group is one process training the example's MLP (dims 32,
64, 64, 64, 10; layers ``layer{i}.w`` / ``layer{i}.b``) on synthetic
batches (the reference's ``np.random.RandomState(replica_id)`` draws) with
AdamW (``optax.adamw(1e-3)``: weight decay 1e-4, eps 1e-8), and
synchronizing one fragment of the model every ``--sync-every /
--num-fragments`` steps through the fault-tolerant Manager (synchronous
quorum): the fragment's pseudogradient is averaged across replica groups
(fp8 with error feedback under ``--quantize``) and stepped by an outer
Nesterov SGD. A replica that rejoins heals live over HTTP, the parameters
and every fragment's globals and momentum, at its first quorum.

A two-replica demo (the lighthouse CLI and the replicas as fresh
interpreters; replica 1 is SIGKILLed and restarted, and the demo exits
non-zero unless it healed and both replicas end with the same fragment
state)::

    python -m torchft_tpu_torch.examples.train_diloco --demo --device cpu

Or the pieces by hand::

    python -m torchft_tpu_torch.lighthouse --bind 127.0.0.1:29510 --min-replicas 2 &
    TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.examples.train_diloco
    TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.examples.train_diloco

Runs on ``cuda`` unless ``--device cpu`` is given; replicas may share one
card. Each replica prints ``[replica i] outer_step=N ...`` at every
fragment sync (the reference prints every ``--sync-every`` steps) and ends
with ``[replica i] done: {json}``: a sha256 of every fragment's globals
and momentum, the reference's ``global_l1[frag0]``, its Manager's metrics
and heal timings, and the fp8 kernels' launch counts.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch import knobs
from torchft_tpu_torch.utils import resolve_device, tensors_sha256

__all__ = ["MLP", "build_trainer", "demo", "main", "train"]

DIMS = (32, 64, 64, 64, 10)
_TIMEOUT_S = 30.0


class MLP(nn.Module):
    """The example's MLP: ``layer{i}.w`` [in, out] (normal / sqrt(in)) and
    ``layer{i}.b`` (zeros), ReLU between layers. Its names flatten in the
    reference's order (sorted), so its fragments are the reference's."""

    def __init__(self, device: "torch.device | str | None" = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        for i, (d_in, d_out) in enumerate(zip(DIMS[:-1], DIMS[1:])):
            layer = nn.Module()
            layer.w = nn.Parameter(torch.randn(d_in, d_out, generator=generator, device=device)
                                   * (1.0 / math.sqrt(d_in)))
            layer.b = nn.Parameter(torch.zeros(d_out, device=device))
            self.add_module(f"layer{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(DIMS) - 1
        for i in range(n):
            layer = getattr(self, f"layer{i}")
            x = x @ layer.w + layer.b
            if i < n - 1:
                x = F.relu(x)
        return x

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self(x), y)


def draw_batch(rng: np.random.RandomState, batch_size: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One synthetic batch, drawn as the reference draws it: x then y."""
    x = rng.randn(batch_size, DIMS[0]).astype(np.float32)
    y = rng.randint(0, DIMS[-1], size=(batch_size,))
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def build_trainer(replica_id: int = 0, device: "torch.device | str | None" = None):
    """The example's model and inner optimizer: ``(model, optimizer)``.

    Replicas initialize differently (seeded by ``replica_id``); the first
    quorum's heal makes them equal. AdamW takes ``optax.adamw(1e-3)``'s
    hyperparameters (torch's default weight decay is 1e-2), and its state
    exists, zero, from the start."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(replica_id)
    model = MLP(dev, gen)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    for p in model.parameters():
        optimizer.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                                  exp_avg_sq=torch.zeros_like(p))
    return model, optimizer


def make_diloco(args: argparse.Namespace, manager: Any, params: Dict[str, torch.Tensor]):
    from torchft_tpu_torch.local_sgd import DiLoCo

    return DiLoCo(
        manager, params,
        lambda ps: torch.optim.SGD(ps, lr=args.outer_lr, momentum=0.9, nesterov=True),
        sync_every=args.sync_every, num_fragments=args.num_fragments,
        fragment_sync_delay=args.fragment_sync_delay,
        fragment_update_alpha=args.fragment_update_alpha, should_quantize=args.quantize,
        # a heal writes these tensors in place: the tree stays valid
        get_params=lambda: params,
    )


def train(args: argparse.Namespace) -> None:
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    device = resolve_device(args.device)
    replica_id = int(os.environ.get("REPLICA_GROUP_ID", args.replica_id))
    lighthouse = knobs.env_raw("TORCHFT_LIGHTHOUSE", args.lighthouse)
    model, optimizer = build_trainer(replica_id, device)
    params = dict(model.named_parameters())

    # the reference heals the parameters (and DiLoCo its fragments), not
    # the inner optimizer's state
    manager = Manager(
        pg=ProcessGroupHost(timeout=_TIMEOUT_S),
        load_state_dict=lambda sd: model.load_state_dict(sd["params"]),
        state_dict=lambda: {"params": model.state_dict()},
        min_replica_size=args.min_replica_size,
        use_async_quorum=False,  # DiLoCo's requirement
        replica_id=f"train_diloco_{replica_id}",
        lighthouse_addr=lighthouse,
        timeout=_TIMEOUT_S,
    )
    try:
        diloco = make_diloco(args, manager, params)
        _train_loop(args, manager, diloco, model, optimizer,
                    np.random.RandomState(replica_id), replica_id)
    finally:
        manager.shutdown(wait=False)


def _train_loop(args: argparse.Namespace, manager: Any, diloco: Any, model: nn.Module,
                optimizer: torch.optim.Optimizer, rng: np.random.RandomState,
                replica_id: int) -> None:
    from torchft_tpu_torch.ops import quantization

    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    target_outer_steps = args.steps // args.sync_every * args.num_fragments
    local = 0
    print(f"[replica {replica_id}] starting at outer step {manager.current_step()}", flush=True)
    try:
        while manager.current_step() < target_outer_steps:
            x, y = draw_batch(rng, args.batch_size, device)
            optimizer.zero_grad()
            loss = model.loss(x, y)
            loss.backward()
            optimizer.step()
            diloco.step(params)
            local += 1
            performed = [frag for kind, frag in diloco.last_step_syncs if kind == "perform"]
            if performed:
                print(f"[replica {replica_id}] outer_step={manager.current_step()} local={local} "
                      f"fragment={performed[0]} loss={loss.item():.4f} "
                      f"healed={manager.last_quorum_healed()}", flush=True)
    finally:
        try:
            # never strand peers on a vote this replica would not cast
            diloco.flush(params)
        except Exception as e:  # noqa: BLE001 - must not mask the loop's exception
            print(f"[replica {replica_id}] flush failed during teardown: {e}", flush=True)
    done = {
        "fragments_sha256": tensors_sha256(diloco.state_tensors()),
        "global_l1[frag0]": sum(float(f.original[0].abs().sum()) for f in diloco.fragments),
        "step": manager.current_step(),
        "local": local,
        "metrics": manager.metrics(),
        "timings": manager.timings(),
        "launches": dict(quantization.LAUNCHES),
    }
    print(f"[replica {replica_id}] done: {json.dumps(done)}", flush=True)


def demo(args: argparse.Namespace) -> None:
    """Start the lighthouse CLI and ``--replicas`` replicas, SIGKILL the
    last one once it printed ``outer_step=--kill-at-outer-step``, restart
    it, and exit with the OR of every
    replica's return code, or 1 if the restarted replica did not heal or
    the replicas' fragment digests differ. The lighthouse wants every
    replica in a quorum, so the survivors wait for the restarted replica
    and it always rejoins through a heal."""
    from torchft_tpu_torch.examples.train_ddp import Fleet

    replica_argv = ["--steps", str(args.steps), "--batch-size", str(args.batch_size),
                    "--outer-lr", str(args.outer_lr), "--sync-every", str(args.sync_every),
                    "--num-fragments", str(args.num_fragments),
                    "--fragment-sync-delay", str(args.fragment_sync_delay),
                    "--fragment-update-alpha", str(args.fragment_update_alpha),
                    "--min-replica-size", str(args.min_replica_size),
                    "--device", args.device or "cuda"]
    if args.quantize:
        replica_argv.append("--quantize")
    fleet = Fleet(replica_argv, ["--min-replicas", str(args.replicas), "--join-timeout-ms", "500",
                                 "--quorum-tick-ms", "50", "--heartbeat-timeout-ms", "2000"],
                  echo=True, module="torchft_tpu_torch.examples.train_diloco")
    rc = 0
    try:
        print(f"lighthouse at {fleet.addr}", flush=True)
        for rid in range(args.replicas):
            fleet.spawn(rid)
        victim = args.replicas - 1
        fleet.wait_line(victim, f"] outer_step={args.kill_at_outer_step} ", 300)
        print(f"--- killing replica {victim} ---", flush=True)
        fleet.kill(victim)
        print(f"--- restarting replica {victim} ---", flush=True)
        fleet.spawn(victim)
        for code in fleet.wait(timeout=300).values():
            rc |= code
        if rc == 0:
            done = {rid: fleet.done(rid) for rid in fleet.procs}
            digests = {d["fragments_sha256"] for d in done.values()}
            healed = done[victim]["metrics"]["heals"] >= 1
            print(f"restarted replica healed: {healed}; fragment digests agree: "
                  f"{len(digests) == 1}", flush=True)
            if not healed or len(digests) != 1:
                rc = 1
    finally:
        fleet.close()
    print("demo finished rc=", rc, flush=True)
    sys.exit(rc)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--outer-lr", type=float, default=0.7)
    parser.add_argument("--sync-every", type=int, default=4)
    parser.add_argument("--num-fragments", type=int, default=2)
    parser.add_argument("--fragment-sync-delay", type=int, default=0)
    parser.add_argument("--fragment-update-alpha", type=float, default=0.0)
    parser.add_argument("--quantize", action="store_true",
                        help="fp8 pseudogradients with error feedback")
    parser.add_argument("--min-replica-size", type=int, default=1)
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument("--lighthouse", type=str, default="127.0.0.1:29510")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--kill-at-outer-step", type=int, default=4,
                        help="demo: kill once the victim printed this outer step's line")
    args = parser.parse_args(argv)
    if args.demo:
        demo(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
