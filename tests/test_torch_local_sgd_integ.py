"""The port's LocalSGD / DiLoCo over real lighthouses and Managers, two
replica groups as threads, against the JAX package's on the same scripts
(``tests/test_local_sgd_integ.py``'s scenarios).

Each test runs the reference scenario first and checks its own invariant
(replicas bitwise equal), so a failure there is the reference's
(``ROADMAP.md`` queue 3 lists these scenarios as timing-sensitive under
parallel workers), then the port's: its replicas bitwise equal, and its
result within 1e-6 of the reference's (fp8 runs: a relative L2 gap of at
most 1e-4). Every lighthouse wants both replicas in a quorum, so a quorum
never forms of one replica and the result does not depend on timing.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch

from torchft_tpu.coordination import LighthouseServer as RefLighthouse
from torchft_tpu.local_sgd import DiLoCo as RefDiLoCo
from torchft_tpu.local_sgd import LocalSGD as RefLocalSGD
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu.process_group import ProcessGroupHost as RefPG
from torchft_tpu_torch.checkpointing import PGTransport
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import ProcessGroupHost

STEPS = 8
SYNC_EVERY = 2
TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_SYNC_EVERY", "TORCHFT_USE_BUCKETIZATION", "TORCHFT_COMPRESS",
                "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB"):
        monkeypatch.delenv(var, raising=False)


class Crash(Exception):
    pass


class Injector:
    """Raises Crash once, when ``replica`` checks in at ``step``."""

    def __init__(self, replica: int, step: int) -> None:
        self.replica, self.step, self.count = replica, step, 0

    def check(self, rid: int, step: int) -> None:
        if rid == self.replica and step == self.step and self.count == 0:
            self.count += 1
            raise Crash()


def _run_threads(fns):
    with ThreadPoolExecutor(max_workers=len(fns)) as ex:
        return [f.result(timeout=120) for f in [ex.submit(fn) for fn in fns]]


class _Pkg:
    """One package's pieces, with numpy leaves for the reference and torch
    tensors for the port."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.Lighthouse = LighthouseServer if port else RefLighthouse
        self.Manager = Manager if port else RefManager
        self.PG = ProcessGroupHost if port else RefPG
        self.LocalSGD = LocalSGD if port else RefLocalSGD

    def arr(self, a):
        return torch.from_numpy(np.array(a, copy=True)) if self.port else np.array(a, copy=True)

    def np(self, x):
        return x.detach().numpy().copy() if self.port else np.asarray(x).copy()

    def lighthouse(self):
        return self.Lighthouse(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                               quorum_tick_ms=20, heartbeat_timeout_ms=3000)

    def manager(self, rid, lighthouse, state, use_async_quorum=False, transport=None):
        def load_state(sd):
            state["params"] = {k: self.arr(np.asarray(v)) for k, v in sd["params"].items()}

        return self.Manager(
            pg=self.PG(timeout=TIMEOUT), load_state_dict=load_state,
            state_dict=lambda: {"params": dict(state["params"])}, min_replica_size=1,
            use_async_quorum=use_async_quorum, replica_id=f"ls_replica_{rid}",
            lighthouse_addr=f"127.0.0.1:{lighthouse.port}", timeout=TIMEOUT,
            quorum_timeout=TIMEOUT, checkpoint_transport=transport,
        )

    def diloco(self, manager, params, lr=1.0, **kw):
        if self.port:
            return DiLoCo(manager, params, lambda ps: torch.optim.SGD(ps, lr=lr), **kw)
        return RefDiLoCo(manager, params, optax.sgd(lr), **kw)


REF, PORT = _Pkg(False), _Pkg(True)


def _in_both(scenario):
    """The reference's outcome (its replicas checked equal first), then the
    port's (its replicas equal too)."""
    outcomes = []
    for pkg in (REF, PORT):
        results = scenario(pkg)
        for a, b in zip(results[0], results[1]):
            np.testing.assert_array_equal(
                a, b, err_msg=f"{'port' if pkg.port else 'reference'}: replicas differ")
        outcomes.append(results)
    return outcomes


def test_localsgd_averages_bitwise_as_the_reference():
    def scenario(pkg):
        lighthouse = pkg.lighthouse()

        def replica(rid):
            state = {"params": {"w": pkg.arr(np.full(2, float(rid), np.float32))}}
            manager = pkg.manager(rid, lighthouse, state, use_async_quorum=True)
            try:
                local_sgd = pkg.LocalSGD(manager, state["params"], sync_every=SYNC_EVERY)
                for _ in range(STEPS):
                    state["params"] = {"w": state["params"]["w"] + (rid + 1) * 0.1}
                    state["params"] = local_sgd.step(state["params"])
                return [pkg.np(state["params"]["w"])]
            finally:
                manager.shutdown(wait=False)

        try:
            return _run_threads([lambda r=r: replica(r) for r in range(2)])
        finally:
            lighthouse.shutdown()

    ref, port = _in_both(scenario)
    np.testing.assert_array_equal(port[0][0], ref[0][0])


def test_diloco_two_replicas_converge_as_the_reference():
    def scenario(pkg):
        lighthouse = pkg.lighthouse()

        def replica(rid):
            state = {"params": {"w": pkg.arr(np.array([0.0], np.float32))}}
            manager = pkg.manager(rid, lighthouse, state)
            try:
                diloco = pkg.diloco(manager, state["params"], sync_every=SYNC_EVERY,
                                    get_params=lambda: state["params"])
                for _ in range(STEPS):
                    state["params"] = {"w": state["params"]["w"] - 0.1 * (rid + 1)}
                    state["params"] = diloco.step(state["params"])
                return [pkg.np(state["params"]["w"]), pkg.np(diloco.fragments[0].original[0])]
            finally:
                manager.shutdown(wait=False)

        try:
            return _run_threads([lambda r=r: replica(r) for r in range(2)])
        finally:
            lighthouse.shutdown()

    ref, port = _in_both(scenario)
    # cycle 1 carries the init_sync heal (replica 1 adopts replica 0's
    # state, so both send 0.2); cycles 2-4 average 0.2 and 0.4
    np.testing.assert_allclose(ref[0][0], [-1.1], rtol=1e-5)
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _crash_recovery(pkg, transport):
    """Two DiLoCo replicas; replica 1 crashes at manager step 1 and its
    restart heals over ``transport``. Returns each replica's final params
    and fragment globals, and the restarted replica's storage record."""
    lighthouse = pkg.lighthouse()
    injector = Injector(replica=1, step=1)
    storage = []

    def replica(rid):
        for _attempt in range(3):
            state = {"params": {"w": pkg.arr(np.array([0.0], np.float32)),
                                "v": pkg.arr(np.zeros(3, np.float32))}}
            recovery_pg = ckpt = manager = None
            if transport == "pg":
                recovery_pg = pkg.PG(timeout=TIMEOUT)
                if pkg.port:
                    ckpt = PGTransport(recovery_pg, timeout=TIMEOUT,
                                       state_dict_template=lambda: manager.state_dict_template())
                else:
                    from torchft_tpu.checkpointing import PGTransport as RefPGTransport

                    ckpt = RefPGTransport(recovery_pg, timeout=TIMEOUT,
                                          state_dict_template=lambda: manager.state_dict_template())
            manager = pkg.manager(rid, lighthouse, state, transport=ckpt)
            try:
                diloco = pkg.diloco(manager, state["params"], sync_every=SYNC_EVERY)
                frag = diloco.fragments[0]
                before = [t.data_ptr() for t in frag.original] if pkg.port else None
                while manager.current_step() < STEPS // SYNC_EVERY:
                    injector.check(rid, manager.current_step())
                    state["params"] = {k: v - 0.1 for k, v in state["params"].items()}
                    state["params"] = diloco.step(state["params"])
                if pkg.port and rid == 1:
                    storage.append(before == [t.data_ptr() for t in frag.original])
                return ([pkg.np(state["params"][k]) for k in ("v", "w")]
                        + [pkg.np(t) for t in frag.original])
            except Crash:
                continue
            finally:
                manager.shutdown(wait=False)
                if recovery_pg is not None:
                    recovery_pg.shutdown()
        raise RuntimeError("attempts exhausted")

    try:
        results = _run_threads([lambda r=r: replica(r) for r in range(2)])
    finally:
        lighthouse.shutdown()
    assert injector.count == 1
    return results, storage


@pytest.mark.parametrize("transport", ["http", "pg"])
def test_diloco_recovers_from_a_crash_as_the_reference(transport):
    storage = []

    def scenario(pkg):
        results, kept = _crash_recovery(pkg, transport)
        storage.extend(kept)
        return results

    ref, port = _in_both(scenario)
    # cycle 1: replica 1 heals (init_sync) with no get_params, so it sends
    # a zero pseudogradient: global -0.1. The restart heals again and sends
    # zero: -0.2. Two joint cycles of 0.2 each: -0.6.
    np.testing.assert_allclose(ref[0][1], [-0.6], rtol=1e-5)
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if transport == "pg":
        # the PG heal landed in the fragment's live globals
        assert storage == [True]


SPREAD = np.linspace(1.0, 1.7, 8).astype(np.float32)


def _quantized_run(pkg, n_leaves, should_quantize=True):
    lighthouse = pkg.lighthouse()

    def replica(rid):
        state = {"params": {f"w{i}": pkg.arr(np.zeros(8, np.float32)) for i in range(n_leaves)}}
        manager = pkg.manager(rid, lighthouse, state)
        try:
            diloco = pkg.diloco(manager, state["params"], sync_every=SYNC_EVERY,
                                should_quantize=should_quantize,
                                get_params=lambda: state["params"])
            for _ in range(STEPS):
                drift = pkg.arr(0.1 * (rid + 1) * SPREAD)
                state["params"] = {k: v - (i + 1) * drift
                                   for i, (k, v) in enumerate(sorted(state["params"].items()))}
                state["params"] = diloco.step(state["params"])
            return [pkg.np(t) for t in diloco.fragments[0].original]
        finally:
            manager.shutdown(wait=False)

    try:
        return _run_threads([lambda r=r: replica(r) for r in range(2)])
    finally:
        lighthouse.shutdown()


@pytest.mark.parametrize("n_leaves", [1, 2], ids=["serial_one_leaf", "streamed_two_leaves"])
def test_quantized_diloco_tracks_the_reference(n_leaves):
    """fp8 pseudogradients (varied drift, so the codes round): one leaf
    rides the serial quantized allreduce, two the streamed compressed
    buckets with error feedback. Measured on the CPU: the globals of the
    two packages agree bit for bit (gap 0.0); the bar is 1e-4."""
    ref, port = _in_both(lambda pkg: _quantized_run(pkg, n_leaves))
    got = np.concatenate(port[0])
    want = np.concatenate(ref[0])
    gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert gap <= 1e-4, gap
    # the codes did round: the unquantized run ends elsewhere
    plain = np.concatenate(_quantized_run(PORT, n_leaves, should_quantize=False)[0])
    assert not np.array_equal(plain, got)


def test_crash_mid_fragment_cycle_streaming_as_the_reference():
    """Streaming DiLoCo (2 fragments, staggered syncs): replica 1 dies
    between the two fragments' syncs, restarts and heals at its first
    prepare while replica 0 waits mid-cycle; both then sync the fragment
    the shared step picks (``current_step % 2``), and both end with the
    same fragment globals, as the reference's replicas do
    (``test_local_sgd_integ.py``'s ``test_crash_mid_fragment_cycle_streaming``).
    Every sync is joint, so both replicas stop at the same step."""
    target = 4

    def scenario(pkg):
        lighthouse = pkg.lighthouse()
        injector = Injector(replica=1, step=5)

        def replica(rid):
            for _attempt in range(3):
                state = {"params": {"w": pkg.arr(np.zeros(4, np.float32)),
                                    "v": pkg.arr(np.zeros(4, np.float32))}}
                manager = pkg.manager(rid, lighthouse, state)
                try:
                    diloco = pkg.diloco(manager, state["params"], sync_every=4, num_fragments=2)
                    inner = 0
                    while manager.current_step() < target:
                        injector.check(rid, inner)
                        state["params"] = {k: v - 0.1 * (rid + 1)
                                           for k, v in state["params"].items()}
                        state["params"] = diloco.step(state["params"])
                        inner += 1
                    return [pkg.np(p) for f in diloco.fragments for p in f.original]
                except Crash:
                    continue
                finally:
                    manager.shutdown(wait=False)
            raise RuntimeError("attempts exhausted")

        try:
            results = _run_threads([lambda r=r: replica(r) for r in range(2)])
        finally:
            lighthouse.shutdown()
        assert injector.count == 1
        return results

    ref, port = _in_both(scenario)
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
