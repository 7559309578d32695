"""The resilient-heal and transient-configure fault scripts of
``tests/test_manager_integ.py`` (``TestResilientHeal``, four cases, and
``TestPGTransportHealing::test_transient_configure_fault_recovers_via_quorum_bump``)
on the port, each against the reference run first in the same test.

Replica groups are threads: a lighthouse, a Manager and a host process
group each, the reference's toy training loop (params ``w`` of 4 floats,
"gradient" ``w * 0.1 + 1``, AVG allreduce, SGD at lr 0.1), a crashed
replica restarting with a fresh Manager. The lighthouse wants every
replica in every quorum, so the scripts do not depend on timing. The
faults come from the reference's ``EventInjector`` (its RPC flakes hooked
into each package's control plane). Held: every replica's sequence of
(step, committed) votes and its final parameters are the reference's, bit
for bit; the replicas agree; and the reference test's own assertions on
the counters.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import pytest
import torch

from torchft_tpu import coordination as ref_coord
from torchft_tpu import process_group as ref_pg
from torchft_tpu._test.event_injector import EventInjector, InjectedFailure
from torchft_tpu.checkpointing import HTTPTransport as RefHTTP
from torchft_tpu.checkpointing import PGTransport as RefPGTransport
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu_torch import coordination as port_coord
from torchft_tpu_torch import process_group as port_pg
from torchft_tpu_torch.checkpointing import HTTPTransport, PGTransport
from torchft_tpu_torch.manager import Manager

NUM_STEPS = 5
LR = 0.1
TIMEOUT = 10.0
# the PG's own timeout: the transient-configure script waits it out once
PG_TIMEOUT = 6.0


class _Pkg:
    def __init__(self, port: bool) -> None:
        self.port = port
        self.coord = port_coord if port else ref_coord
        self.pg = port_pg if port else ref_pg
        self.Manager = Manager if port else RefManager
        self.HTTP = HTTPTransport if port else RefHTTP
        self.PGTransport = PGTransport if port else RefPGTransport

    def arr(self, a: np.ndarray):
        return torch.from_numpy(np.array(a, np.float32)) if self.port else np.array(a, np.float32)

    def np(self, x) -> np.ndarray:
        return x.detach().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


REF, PORT = _Pkg(False), _Pkg(True)


def _replica(pkg: _Pkg, rid: int, addr: str, injector: EventInjector, min_replica_size: int,
             transport_kind: str, http_timeout: float, configure_fails: int) -> Dict:
    """One replica group's run, restarting after an injected crash; its
    votes as (step, committed)."""
    votes: List = []
    for _attempt in range(3):
        rng = np.random.RandomState(rid + 1)
        params = {"w": pkg.arr(rng.randn(4).astype(np.float32))}

        def load_state(sd, params=params):
            params["w"] = pkg.arr(pkg.np(sd["w"]))

        def save_state(params=params):
            return {"w": params["w"].clone() if pkg.port else params["w"].copy()}

        pg = pkg.pg.FakeProcessGroupWrapper(pkg.pg.ProcessGroupHost(timeout=PG_TIMEOUT))
        transport = recovery_pg = None
        if transport_kind == "http" and http_timeout > 0:
            transport = pkg.HTTP(timeout=http_timeout)
        elif transport_kind == "pg":
            recovery_pg = pkg.pg.ProcessGroupHost(timeout=PG_TIMEOUT)
            transport = pkg.PGTransport(recovery_pg, timeout=PG_TIMEOUT)
            if configure_fails:
                real_configure = transport.configure
                remaining = [configure_fails]

                def flaky_configure(*a, real_configure=real_configure, remaining=remaining, **k):
                    if remaining[0] > 0:
                        remaining[0] -= 1
                        raise RuntimeError("injected recovery-store fault")
                    return real_configure(*a, **k)

                transport.configure = flaky_configure
                configure_fails = 0  # a fault of the first incarnation only
        manager = pkg.Manager(
            pg=pg, load_state_dict=load_state, state_dict=save_state,
            min_replica_size=min_replica_size, replica_id=f"replica_{rid}",
            lighthouse_addr=addr, timeout=TIMEOUT, quorum_timeout=TIMEOUT,
            checkpoint_transport=transport,
        )
        try:
            while manager.current_step() < NUM_STEPS:
                injector.check(rid, manager.current_step(), pg,
                               transport=manager._checkpoint_transport)
                step = manager.current_step()
                manager.start_quorum()
                grads = {"w": params["w"] * 0.1 + 1.0}
                reduced = manager.allreduce(grads).get_future().wait(timeout=30)
                committed = manager.should_commit()
                if committed:
                    params["w"] = params["w"] - LR * reduced["w"]
                votes.append((step, committed))
            return {"w": pkg.np(params["w"]), "steps": manager.current_step(), "votes": votes,
                    "timings": manager.timings(), "metrics": manager.metrics()}
        except InjectedFailure:
            votes.append(("crash", manager.current_step()))
            continue
        finally:
            manager.shutdown(wait=False)
            if recovery_pg is not None:
                recovery_pg.shutdown()
    raise RuntimeError(f"replica {rid} exhausted its attempts")


def _run(pkg: _Pkg, make_injector, replicas: int, min_replica_size: int,
         transport_kind: str = "http", http_timeout: float = 0.0, configure_fails=()):
    injector = make_injector()
    pkg.coord.set_rpc_fault_hook(injector._rpc_fault_hook)
    lighthouse = pkg.coord.LighthouseServer(
        bind="127.0.0.1:0", min_replicas=replicas, join_timeout_ms=200, quorum_tick_ms=20,
        heartbeat_timeout_ms=800)
    addr = f"127.0.0.1:{lighthouse.port}"
    try:
        with ThreadPoolExecutor(max_workers=replicas) as ex:
            futs = [ex.submit(_replica, pkg, rid, addr, injector, min_replica_size,
                              transport_kind, http_timeout,
                              configure_fails[rid] if configure_fails else 0)
                    for rid in range(replicas)]
            results = [f.result(timeout=120) for f in futs]
    finally:
        pkg.coord.set_rpc_fault_hook(None)
        lighthouse.shutdown()
    for r in results[1:]:
        np.testing.assert_array_equal(r["w"], results[0]["w"])
    assert all(r["steps"] == NUM_STEPS for r in results)
    return results, injector


def _as_the_reference(*args, **kwargs):
    """The scenario on the reference, then on the port: the same votes and
    the same final parameters, bit for bit."""
    ref, ref_injector = _run(REF, *args, **kwargs)
    port, port_injector = _run(PORT, *args, **kwargs)
    assert port_injector.count == ref_injector.count
    for r, p in zip(ref, port):
        assert p["votes"] == r["votes"]
        np.testing.assert_array_equal(p["w"].view(np.uint32), r["w"].view(np.uint32))
    return ref, port


@pytest.fixture(autouse=True)
def _no_retry_env(monkeypatch):
    for var in ("TORCHFT_RETRY_MAX_ATTEMPTS", "TORCHFT_RETRY_BASE_S", "TORCHFT_RETRY_JITTER",
                "TORCHFT_RETRY_MAX_BACKOFF_S"):
        monkeypatch.delenv(var, raising=False)


def test_source_death_mid_heal_fails_over_and_commits(monkeypatch):
    """Replica 2 crashes and rejoins; its assigned source (replica 0) drops
    every serve of chunk 0, so the heal fails over to replica 1's standby
    snapshot, commits that same step and converges."""
    monkeypatch.setenv("TORCHFT_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("TORCHFT_RETRY_BASE_S", "0.01")
    ref, port = _as_the_reference(
        lambda: EventInjector().fail_at(replica=2, step=2)
        .kill_heal_source_at(replica=0, step=2, chunk=0, times=-1),
        replicas=3, min_replica_size=3, http_timeout=3.0)
    for results in (ref, port):
        healed = results[2]
        assert healed["timings"]["heal_failovers"] >= 1
        assert healed["timings"]["heal_attempts"] >= 1
        assert healed["metrics"]["heals"] >= 1
        assert healed["metrics"]["errors"] == 0


def test_corrupt_chunk_refetched_never_loaded():
    ref, port = _as_the_reference(
        lambda: EventInjector().fail_at(replica=2, step=2)
        .corrupt_heal_chunk_at(replica=0, step=2, chunk=0, times=1),
        replicas=3, min_replica_size=3)
    for results in (ref, port):
        assert results[2]["timings"]["chunk_crc_failures"] >= 1
        assert results[2]["metrics"]["errors"] == 0


@pytest.mark.parametrize("method", ["should_commit", "quorum"])
def test_control_plane_rpc_flake_degrades_to_a_slower_step(method):
    """A one-shot flake of the commit vote's or the quorum's RPC is retried:
    every step commits, no error."""
    ref, port = _as_the_reference(
        lambda: EventInjector().flake_rpc(method, times=1,
                                          delay_s=0.05 if method == "should_commit" else 0.0),
        replicas=2, min_replica_size=2)
    for results in (ref, port):
        assert sum(r["timings"]["rpc_retries"] for r in results) >= 1
        assert all(r["metrics"]["errors"] == 0 for r in results)


def test_transient_configure_fault_recovers_via_quorum_bump():
    """Replica 0's recovery transport fails its configure once: the step's
    vote fails, the next quorum carries commit_failures > 0, the lighthouse
    bumps the quorum id and every replica reconfigures."""
    ref, port = _as_the_reference(EventInjector, replicas=2, min_replica_size=1,
                                  transport_kind="pg", configure_fails=(1, 0))
    for results in (ref, port):
        assert results[0]["metrics"]["commit_failures"] >= 1
        assert results[0]["metrics"]["reconfigures"] >= 2
