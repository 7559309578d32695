"""Fault-tolerant DDP training of Llama: the port's trainer.

Counterpart of ``examples/train_ddp.py``'s ``build_trainer`` and train loop,
running the Llama model. Replica groups are threads of one process on one
device (as ``tests/test_manager_integ.py`` runs them), each with its own
``Manager`` and ``ProcessGroupHost``, against an in-process lighthouse:
per-step quorum, forward and backward, the managed (optionally
fp8-quantized) gradient allreduce, the commit vote, then the optimizer
step. A replica told to fail raises after its backward pass at that step,
restarts with a fresh model and Manager, and heals over HTTP from a peer.

    python -m torchft_tpu_torch.train --config bench_1b --steps 6 \\
        --batch-size 1 --seq-len 2048 --quantize --fail-at 3

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import torch

from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.llama import CONFIGS, Llama
from torchft_tpu_torch.ops import attention as attn_ops
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.process_group import ProcessGroupHost
from torchft_tpu_torch.utils import resolve_device

__all__ = ["TrainConfig", "InjectedFailure", "build_trainer", "run_replicas", "main"]


class InjectedFailure(Exception):
    """A scripted replica crash."""


REPLICAS = 2
LR = 3e-4
# RPC, allreduce and heal deadline: well above a bench_1b step and heal
TIMEOUT_S = 120.0


@dataclasses.dataclass
class TrainConfig:
    config: str = "bench_1b"
    steps: int = 6
    batch_size: int = 1
    seq_len: int = 2048
    quantize: bool = True
    # replica 1 crashes after its backward pass at this step (None: never)
    fail_at: Optional[int] = None


def build_trainer(cfg: TrainConfig, replica_id: int, device: torch.device):
    """The model, its AdamW optimizer and the batch source of one replica.

    Replicas initialize DIFFERENTLY (seeded by ``replica_id``): the first
    quorum's init_sync heal is what makes them identical. Batches depend on
    (replica, step) only, so a restarted replica sees the batches it would
    have seen."""
    model_cfg = CONFIGS[cfg.config]
    # the reference's dispatch (splash for GQA on the card) and its bench's
    # remat="full": per-layer recompute keeps two bench_1b replicas on a card
    model = Llama(model_cfg, device=device, attention="auto", remat=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(replica_id)
    model.init_weights(gen)
    optim = torch.optim.AdamW(model.parameters(), lr=LR)

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
    failed: threading.Event,
    stop: threading.Event,
) -> Dict[str, Any]:
    model, optim, make_batch = build_trainer(cfg, replica_id, device)

    def load_state(sd: Dict[str, Any]) -> None:
        model.load_state_dict(sd["model"])
        optim.load_state_dict(sd["optim"])

    def save_state() -> Dict[str, Any]:
        return {"model": model.state_dict(), "optim": optim.state_dict()}

    manager = Manager(
        pg=ProcessGroupHost(timeout=TIMEOUT_S),
        load_state_dict=load_state,
        state_dict=save_state,
        min_replica_size=1,
        replica_id=f"replica_{replica_id}",
        lighthouse_addr=lighthouse_addr,
        timeout=TIMEOUT_S,
        quorum_timeout=TIMEOUT_S,
    )
    optimizer = OptimizerWrapper(manager, optim)
    tokens_per_step = cfg.batch_size * cfg.seq_len

    def sync() -> float:
        # waits for the whole card: both replica threads launch on the
        # default stream, so a replica's phase times also hold the other
        # replica's work queued in the same window
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    try:
        while manager.current_step() < cfg.steps:
            if stop.is_set():
                raise RuntimeError(f"replica {replica_id}: a peer replica failed")
            step = manager.current_step()
            t0 = sync()
            optimizer.zero_grad()
            inputs, targets = make_batch(step)
            loss = model.loss(inputs, targets)
            loss.backward()
            t1 = sync()
            if replica_id == 1 and cfg.fail_at == step and not failed.is_set():
                failed.set()
                raise InjectedFailure(f"replica {replica_id} crashed at step {step}")
            grads = {n: p.grad for n, p in model.named_parameters()}
            avg = manager.allreduce(grads, should_quantize=cfg.quantize).get_future().wait()
            for n, p in model.named_parameters():
                p.grad = avg[n]
            t2 = sync()
            committed = optimizer.step()
            t3 = sync()
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
            })
        return {
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "step": manager.current_step(),
            "metrics": manager.metrics(),
            "timings": manager.timings(),
        }
    finally:
        manager.shutdown(wait=False)


def run_replicas(
    cfg: TrainConfig,
    device: "str | torch.device | None" = None,
    on_step: Optional[Callable[[Dict[str, Any]], None]] = None,
) -> List[Dict[str, Any]]:
    """Train two replica groups as threads against an
    in-process lighthouse; returns each replica's final state, metrics and
    per-step log. A crashed replica restarts (with a fresh model and
    Manager) until it finishes."""
    dev = resolve_device(device)
    # min_replicas=REPLICAS holds the survivor in quorum while a crashed replica
    # restarts, so the rejoin always goes through a heal
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=REPLICAS,
        join_timeout_ms=1000, quorum_tick_ms=20, heartbeat_timeout_ms=2000,
    )
    addr = f"127.0.0.1:{lighthouse.port}"
    failed = threading.Event()
    # set when a replica fails for real: the others stop at their next step
    # instead of waiting in quorum for a peer that will not come back
    stop = threading.Event()
    errors: List[BaseException] = []
    logs: List[List[Dict[str, Any]]] = [[] for _ in range(REPLICAS)]
    log_lock = threading.Lock()

    def record(entry: Dict[str, Any]) -> None:
        with log_lock:
            logs[entry["replica"]].append(entry)
            if on_step is not None:
                on_step(entry)

    def replica(i: int) -> Dict[str, Any]:
        restarts = 0
        while True:
            try:
                out = _train_replica(cfg, i, addr, dev, record, failed, stop)
                out["restarts"] = restarts
                return out
            except InjectedFailure:
                restarts += 1
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            except BaseException as e:
                with log_lock:
                    if not stop.is_set():
                        errors.append(e)
                        stop.set()
                raise

    try:
        with ThreadPoolExecutor(max_workers=REPLICAS) as ex:
            futs = [ex.submit(replica, i) for i in range(REPLICAS)]
            for f in futs:
                f.exception()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    results = [f.result() for f in futs]
    for i, r in enumerate(results):
        r["log"] = logs[i]
    return results


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="bench_1b", choices=sorted(CONFIGS))
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--quantize", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fail-at", type=int, default=None)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    cfg = TrainConfig(
        config=args.config, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, quantize=args.quantize,
        fail_at=args.fail_at,
    )
    results = run_replicas(
        cfg, args.device, on_step=lambda e: print(json.dumps(e), flush=True)
    )
    for i, r in enumerate(results):
        losses = [e["loss"] for e in r["log"]]
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"replica {i}: non-finite loss")
        print(json.dumps({"replica": i, "step": r["step"], "restarts": r["restarts"],
                          "metrics": r["metrics"]}), flush=True)


if __name__ == "__main__":
    main()
