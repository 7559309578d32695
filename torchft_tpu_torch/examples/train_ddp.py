"""Fault-tolerant data-parallel training example: the port's counterpart of
``examples/train_ddp.py``.

Each replica group is one process training the example's small CNN on
synthetic CIFAR-10-shaped batches (the reference's
``np.random.RandomState(replica_id)`` draws) with SGD, momentum 0.9,
fault-tolerant across replica groups: per-step quorum, the managed
allreduce of the gradients (streamed; fp8 with error feedback under
``--quantize``; one streamed allreduce per microbatch under
``--grad-accum``), the commit vote, and a live heal on rejoin, over HTTP
or, with ``--transport pg``, over a recovery process group of its own into
the live model and optimizer state.

A two-replica demo (the lighthouse CLI and the replicas as fresh
interpreters; one replica is killed and restarted)::

    python -m torchft_tpu_torch.examples.train_ddp --demo --device cpu

Or the pieces by hand::

    python -m torchft_tpu_torch.lighthouse --bind 127.0.0.1:29510 &
    TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.examples.train_ddp
    TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.examples.train_ddp

Runs on ``cuda`` unless ``--device cpu`` is given; replicas may share one
card. Each replica prints ``[replica i] step=N ...`` per committed step and
ends with ``[replica i] done: {json}``: a sha256 of its parameters, its
Manager's metrics and heal timings, the fp8 kernels' launch counts and the
policy plane's ``policy_seq``, ``policy_intents`` and ``policy_applies``
(``TORCHFT_POLICY=observe`` with the lighthouse's ``--policy builtin``
records an intent a frame).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch import knobs
from torchft_tpu_torch.utils import resolve_device, true_divide

__all__ = ["CNN", "Fleet", "build_trainer", "demo", "main", "train"]

# the directory holding the package: fresh interpreters run from it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TIMEOUT_S = 30.0


class CNN(nn.Module):
    """The example's tiny CNN on 32x32x3 NHWC inputs, in the reference's
    layouts: ``conv`` [3, 3, 3, 16] (HWIO), stride 2 with JAX's SAME
    padding (0 before, 1 after: not ``padding=1``); ReLU; the NHWC flatten
    into ``w1`` [4096, 64]; ReLU; ``w2`` [64, 10]."""

    def __init__(self, device: "torch.device | str | None" = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()

        def normal(shape: Tuple[int, ...], scale: float) -> nn.Parameter:
            return nn.Parameter(torch.randn(shape, generator=generator, device=device) * scale)

        self.conv = normal((3, 3, 3, 16), 0.1)
        self.w1 = normal((16 * 16 * 16, 64), 0.05)
        self.w2 = normal((64, 10), 0.05)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        h = F.relu(F.conv2d(h, self.conv.permute(3, 2, 0, 1), stride=2))
        h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        h = F.relu(h @ self.w1)
        return h @ self.w2

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self(x), y)


def draw_batch(rng: np.random.RandomState, batch_size: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One synthetic batch, drawn as the reference draws it: x then y."""
    x = rng.randn(batch_size, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(batch_size,))
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def build_trainer(replica_id: int = 0, batch_size: int = 8, lr: float = 0.01,
                  device: "torch.device | str | None" = None):
    """The example's model, gradient function, optimizer and batch source:
    ``(model, grad_fn, optimizer, make_batch)``. ``grad_fn(x, y)`` returns
    ``(loss, {name: grad})`` without touching ``.grad``.

    Replicas initialize differently (seeded by ``replica_id``): the first
    quorum's init_sync heal makes them equal. The optimizer's momentum
    buffers exist, zero, from the start (``optax.sgd``'s trace starts at
    zero; torch would create them at the first step), so a heal at step 0
    carries the same tree as any later one."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(replica_id)
    model = CNN(dev, gen)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    for p in model.parameters():
        optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
    params = dict(model.named_parameters())

    def grad_fn(x: torch.Tensor, y: torch.Tensor):
        loss = model.loss(x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    rng = np.random.RandomState(replica_id)

    def make_batch():
        return draw_batch(rng, batch_size, dev)

    return model, grad_fn, optimizer, make_batch


def params_digest(model: nn.Module) -> str:
    """sha256 of the parameters' bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train(args: argparse.Namespace) -> None:
    from torchft_tpu_torch.checkpointing import PGTransport
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    device = resolve_device(args.device)
    replica_id = int(os.environ.get("REPLICA_GROUP_ID", args.replica_id))
    lighthouse = knobs.env_raw("TORCHFT_LIGHTHOUSE", args.lighthouse)
    model, grad_fn, optimizer, _make_batch = build_trainer(
        replica_id, args.batch_size, args.lr, device
    )

    def load_state(sd: Dict[str, Any]) -> None:
        model.load_state_dict(sd["params"])
        optimizer.load_state_dict(sd["opt_state"])

    def save_state() -> Dict[str, Any]:
        return {"params": model.state_dict(), "opt_state": optimizer.state_dict()}

    # --transport pg: the heal rides a recovery process group of its own
    # (one generation carries p2p or collective traffic, never both),
    # received in place into the live state
    transport = recovery_pg = None
    manager: Optional[Manager] = None
    if args.transport == "pg":
        recovery_pg = ProcessGroupHost(timeout=_TIMEOUT_S)
        transport = PGTransport(recovery_pg, timeout=_TIMEOUT_S,
                                state_dict_template=lambda: manager.state_dict_template())
    manager = Manager(
        pg=ProcessGroupHost(timeout=_TIMEOUT_S),
        load_state_dict=load_state,
        state_dict=save_state,
        min_replica_size=args.min_replica_size,
        replica_id=f"train_ddp_{replica_id}",
        lighthouse_addr=lighthouse,
        timeout=_TIMEOUT_S,
        checkpoint_transport=transport,
    )
    rng = np.random.RandomState(replica_id)
    print(f"[replica {replica_id}] starting at step {manager.current_step()}", flush=True)
    try:
        _train_loop(args, manager, model, grad_fn, optimizer, rng, replica_id)
    finally:
        manager.shutdown(wait=False)
        if recovery_pg is not None:
            recovery_pg.shutdown()  # the transport leaves its PG alone


def _train_loop(args: argparse.Namespace, manager: Any, model: nn.Module,
                grad_fn: Callable, optimizer: torch.optim.Optimizer,
                rng: np.random.RandomState, replica_id: int) -> None:
    from torchft_tpu_torch.ops import quantization

    device = next(model.parameters()).device
    accum = max(1, args.grad_accum)
    step_ms: List[float] = []
    while manager.current_step() < args.steps:
        t0 = time.perf_counter()
        x, y = draw_batch(rng, args.batch_size, device)
        manager.start_quorum()
        if accum > 1:
            # one streamed allreduce per microbatch: its buckets reduce while
            # the next microbatch's gradients are computed. The allreduce is
            # linear, so the mean of the reduced means is the reduced mean.
            streams = []
            for k in range(accum):
                if k > 0:
                    x, y = draw_batch(rng, args.batch_size, device)
                loss, grads = grad_fn(x, y)
                streams.append(manager.allreduce_streamed(grads, should_quantize=args.quantize))
            trees = [s.wait(timeout=60) for s in streams]
            reduced = {k: true_divide(sum(t[k] for t in trees), len(trees)) for k in trees[0]}
        else:
            loss, grads = grad_fn(x, y)
            reduced = manager.allreduce(
                grads, should_quantize=args.quantize
            ).get_future().wait(timeout=60)
        if manager.should_commit():
            for name, p in model.named_parameters():
                p.grad = reduced[name]
            optimizer.step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(
                f"[replica {replica_id}] step={manager.current_step()} "
                f"loss={float(loss):.4f} participants={manager.num_participants()} "
                f"healed={manager.last_quorum_healed()} step_ms={step_ms[-1]:.2f}",
                flush=True,
            )
    done = {
        "w2_l1": float(model.w2.detach().abs().sum()),
        "params_sha256": params_digest(model),
        "step": manager.current_step(),
        "step_ms_median": statistics.median(step_ms) if step_ms else None,
        "metrics": manager.metrics(),
        "timings": manager.timings(),
        "launches": dict(quantization.LAUNCHES),
        # the policy plane (TORCHFT_POLICY): the newest frame seen, and the
        # frames applied (enforce) or only recorded (observe)
        **{k: int(manager.timings()[k]) for k in ("policy_seq", "policy_intents",
                                                   "policy_applies")},
    }
    print(f"[replica {replica_id}] done: {json.dumps(done)}", flush=True)


class Fleet:
    """The lighthouse CLI and the replica processes of one run (``python -m
    module``, this example's by default), each a fresh interpreter
    (spawned, never forked: a child may hold a CUDA context) in a session
    of its own. A replica group of ``ranks`` > 1 is that many processes,
    started together with torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) on a rendezvous store the fleet hosts
    for each incarnation, as torchrun's agent does. Every output line is
    kept, per replica group and in one transcript. ``close()`` kills
    whatever still runs."""

    def __init__(self, replica_argv: Sequence[str], lighthouse_argv: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None, echo: bool = False,
                 timeout: float = 60.0,
                 module: str = "torchft_tpu_torch.examples.train_ddp",
                 ranks: int = 1) -> None:
        self._argv = list(replica_argv)
        # the replicas' entry point: ``python -m <module> <replica_argv>``
        self._module = module
        self._ranks = ranks
        self._env = dict(os.environ if env is None else env)
        self._echo = echo
        self._cond = threading.Condition()
        self.transcript: List[str] = []
        self.lines: Dict[int, List[str]] = {}
        # each replica group's processes, in rank order
        self.procs: Dict[int, List[subprocess.Popen]] = {}
        self._stores: Dict[int, Any] = {}
        self.lighthouse = self._popen(
            [sys.executable, "-m", "torchft_tpu_torch.lighthouse", "--bind", "127.0.0.1:0",
             *lighthouse_argv], "lighthouse", self._env, None,
        )
        try:
            line = self.wait_line(None, "lighthouse listening at ", timeout)
        except TimeoutError:
            self.close()
            raise
        self.addr = line.split("lighthouse listening at ", 1)[1].strip()

    def _popen(self, argv: List[str], tag: str, env: Dict[str, str],
               sink: Optional[List[str]]) -> subprocess.Popen:
        """Start ``argv``; its lines go to the transcript and to ``sink``
        (bound here: a killed process's last lines never reach the list of
        the process that replaces it)."""
        proc = subprocess.Popen(
            argv, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True,
        )

        def pump() -> None:
            for line in proc.stdout:
                with self._cond:
                    self.transcript.append(f"{tag}: {line.rstrip()}")
                    if sink is not None:
                        sink.append(line.rstrip())
                    self._cond.notify_all()
                    if self._echo:  # under the lock: one line at a time
                        print(f"{tag}: {line.rstrip()}", flush=True)

        threading.Thread(target=pump, daemon=True, name=f"fleet_{tag}").start()
        return proc

    def spawn(self, rid: int) -> List[subprocess.Popen]:
        """Start replica group ``rid``, all its ranks (a restart replaces its
        processes and its lines)."""
        sink: List[str] = []
        with self._cond:
            self.lines[rid] = sink
        env = dict(self._env, TORCHFT_LIGHTHOUSE=self.addr, REPLICA_GROUP_ID=str(rid))
        envs = [env]
        if self._ranks > 1:
            from torch.distributed import TCPStore

            # a fresh store per incarnation: no key of a killed one survives
            store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
            self._stores[rid] = store
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                       WORLD_SIZE=str(self._ranks), TORCHELASTIC_USE_AGENT_STORE="True")
            envs = [dict(env, RANK=str(r)) for r in range(self._ranks)]
        self.procs[rid] = [
            self._popen([sys.executable, "-m", self._module, *self._argv],
                        f"replica {rid}" + (f" rank {r}" if self._ranks > 1 else ""), e, sink)
            for r, e in enumerate(envs)
        ]
        return self.procs[rid]

    def wait_line(self, rid: Optional[int], needle: str, timeout: float) -> str:
        """The first line of replica group ``rid`` (None: any process)
        holding ``needle``; raises TimeoutError after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                pool = self.transcript if rid is None else self.lines.get(rid, [])
                for line in pool:
                    if needle in line:
                        return line
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"no line with {needle!r} within {timeout} s")
                self._cond.wait(left)

    def kill(self, rid: int) -> None:
        """SIGKILL every process of replica group ``rid`` and reap them."""
        for proc in self.procs[rid]:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:  # it exited since the poll
                    pass
            proc.wait()

    def wait(self, timeout: float) -> Dict[int, int]:
        """Every replica group's exit code (the OR of its processes'); a
        group still running past ``timeout`` is killed and counted as 1."""
        deadline = time.monotonic() + timeout
        rcs = {}
        for rid, procs in self.procs.items():
            try:
                rcs[rid] = 0
                for proc in procs:
                    rcs[rid] |= proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill(rid)
                rcs[rid] = 1
        return rcs

    def done(self, rid: int, rank: Optional[int] = None) -> Dict[str, Any]:
        """The JSON of replica group ``rid``'s ``done:`` line (of group rank
        ``rank``, for a trainer whose lines name it)."""
        needle = "] done: " if rank is None else f" rank {rank}] done: "
        line = self.wait_line(rid, needle, 0)
        return json.loads(line.split("] done: ", 1)[1])

    def close(self) -> int:
        """Kill the replicas still running, stop the lighthouse with SIGTERM;
        returns the lighthouse's exit code."""
        for rid in self.procs:
            self.kill(rid)
        self._stores.clear()
        if self.lighthouse.poll() is None:
            self.lighthouse.send_signal(signal.SIGTERM)
            try:
                self.lighthouse.wait(timeout=10)
            except subprocess.TimeoutExpired:
                os.killpg(self.lighthouse.pid, signal.SIGKILL)
                self.lighthouse.wait()
        return self.lighthouse.returncode


def demo(args: argparse.Namespace) -> None:
    """Start the lighthouse CLI and ``--replicas`` replicas, kill the last
    one (after ``--kill-after`` seconds, or once it printed its step line
    ``--kill-at-step``), restart it, and exit with the OR of every
    replica's return code. The lighthouse wants every replica in a quorum
    (the reference's demo wants one), so the survivors wait for the
    restarted replica and it always rejoins through a heal."""
    replica_argv = ["--steps", str(args.steps), "--batch-size", str(args.batch_size),
                    "--grad-accum", str(args.grad_accum), "--lr", str(args.lr),
                    "--min-replica-size", str(args.min_replica_size),
                    "--transport", args.transport, "--device", args.device or "cuda"]
    if args.quantize:
        replica_argv.append("--quantize")
    fleet = Fleet(replica_argv, ["--min-replicas", str(args.replicas), "--join-timeout-ms", "500",
                                 "--quorum-tick-ms", "50", "--heartbeat-timeout-ms", "2000"],
                  echo=True)
    rc = 0
    try:
        print(f"lighthouse at {fleet.addr}", flush=True)
        for rid in range(args.replicas):
            fleet.spawn(rid)
        victim = args.replicas - 1
        if args.kill_at_step is not None:
            fleet.wait_line(victim, f"] step={args.kill_at_step} ", 300)
        else:
            time.sleep(args.kill_after)
        print(f"--- killing replica {victim} ---", flush=True)
        fleet.kill(victim)
        print(f"--- restarting replica {victim} ---", flush=True)
        fleet.spawn(victim)
        for code in fleet.wait(timeout=300).values():
            rc |= code
    finally:
        fleet.close()
    print("demo finished rc=", rc, flush=True)
    sys.exit(rc)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="microbatches per step; >1 streams one allreduce per microbatch")
    parser.add_argument("--quantize", action="store_true",
                        help="stream gradient buckets fp8-coded with error feedback")
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--min-replica-size", type=int, default=1)
    parser.add_argument("--transport", choices=["http", "pg"], default="http",
                        help="heal transport: http, or pg (a recovery process group)")
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument("--lighthouse", type=str, default="127.0.0.1:29510")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--kill-after", type=float, default=6.0)
    parser.add_argument("--kill-at-step", type=int, default=None,
                        help="demo: kill once the victim printed this step's line")
    args = parser.parse_args(argv)
    if args.demo:
        demo(args)
    else:
        train(args)


if __name__ == "__main__":
    main()
