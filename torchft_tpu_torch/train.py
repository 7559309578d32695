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
pg``) over a recovery ``ProcessGroupHost`` each replica owns. Either way
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
``times`` calls of RPC ``method``, by any replica, fail once each).
``--http-timeout`` sets the HTTP transport's own timeout (its serve
socket's and its serving window's grace).

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

A replica's result sums its resilience counters (the Manager's lifetime
counters: ``rpc_retries``, heals, ...) over all its incarnations, so what a crashed
incarnation counted (an RPC flake fired on any replica's next call) is not
lost with it.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch import coordination
from torchft_tpu_torch.checkpointing import HTTPTransport, PGTransport
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import _COUNTERS, Manager
from torchft_tpu_torch.models.llama import CONFIGS, Llama
from torchft_tpu_torch.models.moe import MOE_CONFIGS, MoE
from torchft_tpu_torch.models.remat import REMAT_MODES
from torchft_tpu_torch.ops import attention as attn_ops
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.process_group import ProcessGroupHost
from torchft_tpu_torch.utils import resolve_device, tensors_sha256

__all__ = ["TrainConfig", "Fault", "InjectedFailure", "build_trainer", "run_replicas", "main"]


class InjectedFailure(Exception):
    """A scripted replica crash. ``counters`` carries the crashed
    incarnation's resilience counters to the replica's result."""

    counters: Dict[str, float] = {}


FAULT_KINDS = ("crash", "kill_heal_chunk", "corrupt_heal_chunk", "flake_rpc")
# where in a step a fault fires: before its quorum, or after its backward pass
FAULT_POINTS = ("start", "backward")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault: fires once, when ``replica`` reaches point ``at``
    of ``step`` (an inner step under DiLoCo)."""

    replica: int
    step: int
    kind: str
    chunk: int = 0  # the heal chunk of kill_heal_chunk / corrupt_heal_chunk
    times: int = 1  # serves (-1: every serve) or RPC calls that fail
    method: str = "should_commit"  # the RPC of flake_rpc
    at: str = "start"  # FAULT_POINTS

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected one of {FAULT_KINDS}")
        if self.at not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.at!r}: expected one of {FAULT_POINTS}")


class _FaultScript:
    """The faults of one run, shared by every incarnation of a replica, so
    each fires once. ``flake_rpc`` installs a process-wide RPC fault hook,
    removed by ``close``."""

    def __init__(self, faults: Tuple[Fault, ...]) -> None:
        self._lock = threading.Lock()
        self._pending = list(faults)
        self._rpc_flakes: Dict[str, int] = {}
        self.fired: List[Fault] = []

    def check(self, replica: int, step: int, at: str, transport: Any) -> None:
        with self._lock:
            due = [f for f in self._pending if (f.replica, f.step, f.at) == (replica, step, at)]
            for f in due:
                self._pending.remove(f)
                self.fired.append(f)
        for f in due:
            if f.kind == "crash":
                raise InjectedFailure(f"replica {replica} crashed at step {step}")
            if f.kind == "flake_rpc":
                with self._lock:
                    self._rpc_flakes[f.method] = self._rpc_flakes.get(f.method, 0) + f.times
                coordination.set_rpc_fault_hook(self._rpc_hook)
            else:
                if not isinstance(transport, HTTPTransport):
                    raise ValueError(f"{f.kind} needs the HTTP transport")
                mode = "die" if f.kind == "kill_heal_chunk" else "corrupt"
                transport.inject_chunk_fault(f.chunk, mode, times=f.times)

    def _rpc_hook(self, method: str, addr: str) -> Optional[Exception]:
        with self._lock:
            if self._rpc_flakes.get(method, 0) <= 0:
                return None
            self._rpc_flakes[method] -= 1
        return ConnectionError(f"injected rpc flake: {method} -> {addr}")

    def close(self) -> None:
        if any(f.kind == "flake_rpc" for f in self.fired):
            coordination.set_rpc_fault_hook(None)


REPLICAS = 2
LR = 3e-4
# Manager.timings() keys of the streamed allreduce, copied into each step's log
PIPELINE_TIMINGS = ("allreduce_pack_s", "allreduce_wire_s", "allreduce_unpack_s",
                    "allreduce_buckets", "overlap_efficiency")
# RPC, allreduce and heal deadline: well above a bench_1b step and heal
TIMEOUT_S = 120.0
# the model families --model chooses from, each with its configs
MODELS = {"llama": (Llama, CONFIGS), "moe": (MoE, MOE_CONFIGS)}


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
    # the heal's checkpoint transport: "http" or "pg"
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


def build_trainer(cfg: TrainConfig, replica_id: int, device: torch.device):
    """The model, its AdamW optimizer and the batch source of one replica.

    Replicas initialize DIFFERENTLY (seeded by ``replica_id``): the first
    quorum's init_sync heal is what makes them identical. Batches depend on
    (replica, step) only, so a restarted replica sees the batches it would
    have seen."""
    model_cls, configs = MODELS[cfg.model]
    model_cfg = configs[cfg.config]
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
) -> Dict[str, Any]:
    model, optim, make_batch = build_trainer(cfg, replica_id, device)

    def load_state(sd: Dict[str, Any]) -> None:
        model.load_state_dict(sd["model"])
        optim.load_state_dict(sd["optim"])

    def save_state() -> Dict[str, Any]:
        return {"model": model.state_dict(), "optim": optim.state_dict()}

    pg = ProcessGroupHost(timeout=TIMEOUT_S)
    recovery_pg = None
    manager: Optional[Manager] = None
    transport: Any
    if cfg.transport == "pg":
        # its own PG: one generation carries p2p or collective traffic
        recovery_pg = ProcessGroupHost(timeout=TIMEOUT_S)
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
    )
    tokens_per_step = cfg.batch_size * cfg.seq_len

    def sync() -> float:
        # waits for the whole card: both replica threads launch on the
        # default stream, so a replica's phase times also hold the other
        # replica's work queued in the same window
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    optimizer = OptimizerWrapper(manager, optim)

    def storage() -> List[int]:
        # every tensor a heal lands in: the model and AdamW's state
        tensors = [*model.parameters(), *(t for st in optim.state.values() for t in st.values())]
        return [t.data_ptr() for t in tensors if isinstance(t, torch.Tensor)]

    storage0 = storage()
    try:
        if cfg.diloco:
            return _diloco_loop(cfg, replica_id, model, optim, make_batch, manager, pg,
                                transport, sync, on_step, stop, script)
        while manager.current_step() < cfg.steps:
            if stop.is_set():
                raise RuntimeError(f"replica {replica_id}: a peer replica failed")
            step = manager.current_step()
            script.check(replica_id, step, "start", transport)
            t0 = sync()
            optimizer.zero_grad()
            inputs, targets = make_batch(step)
            loss = model.loss(inputs, targets)
            loss.backward()
            t1 = sync()
            script.check(replica_id, step, "backward", transport)
            grads = {n: p.grad for n, p in model.named_parameters()}
            wire0 = pg.wire_stats()
            avg = manager.allreduce(grads, should_quantize=cfg.quantize).get_future().wait()
            for n, p in model.named_parameters():
                p.grad = avg[n]
            t2 = sync()
            wire1 = pg.wire_stats()
            timings = manager.timings()
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
                # the streamed pipeline's stages, summed over buckets (the
                # last streamed allreduce's: absent before the first)
                **{k: timings.get(k, 0.0) for k in PIPELINE_TIMINGS},
                # this step's wire
                "wire_bytes_sent": wire1["bytes_sent"] - wire0["bytes_sent"],
                "wire_busy_s": wire1["busy_s"] - wire0["busy_s"],
                **_moe_stats(model),
            })
        return {
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "step": manager.current_step(),
            # whether the model and AdamW's state kept their storage through
            # the heals (both transports land in place)
            "storage_kept": storage() == storage0,
            "metrics": manager.metrics(),
            "timings": manager.timings(),
        }
    except InjectedFailure as e:
        e.counters = _resilience(manager)
        raise
    finally:
        manager.shutdown(wait=False)
        if recovery_pg is not None:
            recovery_pg.shutdown()


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
                 make_batch: Callable, manager: Manager, pg: ProcessGroupHost, transport: Any,
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
        wire0 = pg.wire_stats()
        commits0 = manager.metrics()["commits"]
        diloco.step(params)
        t2 = sync()
        wire1 = pg.wire_stats()
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
) -> List[Dict[str, Any]]:
    """Train ``cfg.replicas`` replica groups as threads against an
    in-process lighthouse; returns each replica's final state, metrics and
    per-step log. A crashed replica restarts (with a fresh model and
    Manager) until it finishes."""
    dev = resolve_device(device)
    n_replicas = cfg.replicas
    # min_replicas = every replica holds the survivors in quorum while a
    # crashed replica restarts, so the rejoin always goes through a heal
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=n_replicas,
        join_timeout_ms=1000, quorum_tick_ms=20, heartbeat_timeout_ms=2000,
    )
    addr = f"127.0.0.1:{lighthouse.port}"
    # set when a replica fails for real: the others stop at their next step
    # instead of waiting in quorum for a peer that will not come back
    stop = threading.Event()
    errors: List[BaseException] = []
    logs: List[List[Dict[str, Any]]] = [[] for _ in range(n_replicas)]
    script = _FaultScript(cfg.faults)
    log_lock = threading.Lock()

    def record(entry: Dict[str, Any]) -> None:
        with log_lock:
            logs[entry["replica"]].append(entry)
            if on_step is not None:
                on_step(entry)

    def replica(i: int) -> Dict[str, Any]:
        restarts = 0
        # the crashed incarnations' resilience counters
        carried: Dict[str, float] = {}
        while True:
            try:
                out = _train_replica(cfg, i, addr, dev, record, stop, script)
                out["restarts"] = restarts
                for k, n in carried.items():
                    (out["metrics"] if k == "heals" else out["timings"])[k] += n
                return out
            except InjectedFailure as e:
                restarts += 1
                for k, n in e.counters.items():
                    carried[k] = carried.get(k, 0) + n
            except BaseException as e:
                with log_lock:
                    if not stop.is_set():
                        errors.append(e)
                        stop.set()
                raise
            # past the handler (the crash's traceback is gone): the crashed
            # incarnation's model, optimizer state and EF residuals sit in
            # reference cycles (its PGTransport's template closure holds its
            # Manager); free them before the restart allocates its own, or
            # the card holds both
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    try:
        with ThreadPoolExecutor(max_workers=n_replicas) as ex:
            futs = [ex.submit(replica, i) for i in range(n_replicas)]
            for f in futs:
                f.exception()
    finally:
        script.close()
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    results = [f.result() for f in futs]
    for i, r in enumerate(results):
        r["log"] = logs[i]
    return results


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="llama", choices=sorted(MODELS),
                   help="the model family: llama (CONFIGS) or moe (MOE_CONFIGS)")
    p.add_argument("--config", default="bench_1b",
                   help="a config of the model family (llama: %s; moe: %s)"
                        % (", ".join(sorted(CONFIGS)), ", ".join(sorted(MOE_CONFIGS))))
    p.add_argument("--remat", default="full", choices=REMAT_MODES,
                   help="each layer's rematerialization mode")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--quantize", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fail-at", type=int, default=None,
                   help="replica 1 crashes after this step's backward pass")
    p.add_argument("--replicas", type=int, default=REPLICAS,
                   help="replica groups (threads); the lighthouse wants all of them")
    p.add_argument("--transport", choices=["http", "pg"], default="http",
                   help="heal transport: http, or pg (a recovery process group)")
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
    args = p.parse_args(argv)
    if args.config not in MODELS[args.model][1]:
        p.error(f"--config {args.config!r} is not a {args.model} config: "
                f"{sorted(MODELS[args.model][1])}")
    cfg = TrainConfig(
        config=args.config, model=args.model, remat=args.remat, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, quantize=args.quantize,
        faults=() if args.fail_at is None else (Fault(1, args.fail_at, "crash", at="backward"),),
        transport=args.transport, diloco=args.diloco,
        sync_every=args.sync_every, num_fragments=args.num_fragments,
        fragment_sync_delay=args.fragment_sync_delay, outer_lr=args.outer_lr,
        replicas=args.replicas, http_timeout=args.http_timeout,
    )
    results = run_replicas(
        cfg, args.device, on_step=lambda e: print(json.dumps(e), flush=True)
    )
    digests = []
    for i, r in enumerate(results):
        losses = [e["loss"] for e in r["log"]]
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"replica {i}: non-finite loss")
        line = {"replica": i, "step": r["step"], "restarts": r["restarts"],
                "metrics": r["metrics"]}
        if cfg.diloco:
            line["fragments_sha256"] = tensors_sha256(r["fragment_state"])
            digests.append(line["fragments_sha256"])
        print(json.dumps(line), flush=True)
    if len(set(digests)) > 1:
        raise SystemExit(f"replicas' fragment state differs: {digests}")


if __name__ == "__main__":
    main()
