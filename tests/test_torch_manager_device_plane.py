"""The port's Manager on the device plane (``ProcessGroupDevice`` in local
mode, replica groups as threads) against the JAX package's on
``ProcessGroupXLA``: the reference's ``TestDevicePlaneShardedHeal``
(crash, rejoin, heal over ``PGTransport`` on a host recovery group),
``_dryrun_fixed_with_spares`` (``__graft_entry__.py:537``), the managed
allreduce raw and fp8-quantized, the async quorum kept, DiLoCo's
parameter history, and the trainer's ``--plane device``.

Every lighthouse wants all replicas in a quorum, and the replicas meet
at a barrier before they shut down (a replica leaving a local-mode
generation fails its peers' pending ops; the reference's group then reads
errored even with none pending), so the scripts do not depend on timing. Tolerances: at world 2 the votes, the final parameters
and the reduced gradients equal the reference's bit for bit (a sum of two
floats has one rounding); DiLoCo's history is held to 1e-6 relative (the
reference's outer step runs in optax, the port's in torch.optim, as
``tests/test_torch_local_sgd_integ.py`` holds them); the trainer's
unquantized run on the device plane equals its host-plane run bit for bit
(both sum two f32 contributions once).
"""

import threading
import types
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.checkpointing import PGTransport as RefPGTransport
from torchft_tpu.coordination import LighthouseServer as RefLighthouse
from torchft_tpu.local_sgd import DiLoCo as RefDiLoCo
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu.manager import WorldSizeMode as RefWorldSizeMode
from torchft_tpu.process_group import ProcessGroupHost as RefHost
from torchft_tpu.process_group_xla import ProcessGroupXLA
from torchft_tpu_torch import train
from torchft_tpu_torch.checkpointing import PGTransport
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager, WorldSizeMode
from torchft_tpu_torch.process_group import ProcessGroupHost
from torchft_tpu_torch.process_group_device import ProcessGroupDevice
from torchft_tpu_torch.work import Future

TIMEOUT = 10.0
NUM_STEPS = 4


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_SYNC_EVERY", "TORCHFT_USE_BUCKETIZATION", "TORCHFT_COMPRESS",
                "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB"):
        monkeypatch.delenv(var, raising=False)


class Died(Exception):
    pass


class _Pkg:
    def __init__(self, port: bool) -> None:
        self.port = port
        self.Lighthouse = LighthouseServer if port else RefLighthouse
        self.Manager = Manager if port else RefManager
        self.DevicePG = ProcessGroupDevice if port else ProcessGroupXLA
        self.HostPG = ProcessGroupHost if port else RefHost
        self.PGTransport = PGTransport if port else RefPGTransport
        self.WorldSizeMode = WorldSizeMode if port else RefWorldSizeMode

    def arr(self, a):
        return torch.from_numpy(np.array(a, np.float32)) if self.port else jnp.asarray(
            np.array(a, np.float32))

    def np(self, x):
        return x.detach().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)

    def is_device(self, x) -> bool:
        import jax

        return isinstance(x, torch.Tensor) if self.port else isinstance(x, jax.Array)

    def lighthouse(self, min_replicas):
        return self.Lighthouse(bind="127.0.0.1:0", min_replicas=min_replicas,
                               join_timeout_ms=5000, quorum_tick_ms=20,
                               heartbeat_timeout_ms=2000)

    def manager(self, rid, lh, load, save, **kw):
        return self.Manager(
            pg=self.DevicePG(timeout=TIMEOUT, mode="local"), load_state_dict=load,
            state_dict=save, min_replica_size=kw.pop("min_replica_size", 1),
            replica_id=f"device_plane_{rid}", lighthouse_addr=f"127.0.0.1:{lh.port}",
            timeout=TIMEOUT, quorum_timeout=TIMEOUT, **kw)


REF, PORT = _Pkg(False), _Pkg(True)


def _threads(n, fn):
    with ThreadPoolExecutor(max_workers=n) as ex:
        return [f.result(timeout=120) for f in [ex.submit(fn, r) for r in range(n)]]


def _heal_scenario(pkg):
    """``TestDevicePlaneShardedHeal``'s script: replicas start unlike (the
    init_sync heal makes them equal), replica 1 dies after its quorum of
    step 2 and rejoins, healing over PGTransport on a host recovery group.
    Returns each replica's (step, committed) votes, final ``w``, whether the
    healed leaves came delivered in place, and the allreduce's leaf types."""
    lh = pkg.lighthouse(min_replicas=2)
    died = []
    done = threading.Barrier(2, timeout=60)

    def replica(rid):
        votes, on_device, delivered = [], [], []
        for _attempt in range(3):
            state = {"w": pkg.arr(np.full(16, rid + 1.0))}

            def load_state(sd, state=state):
                delivered.append(pkg.is_device(sd["w"]))
                state["w"] = sd["w"] if pkg.is_device(sd["w"]) else pkg.arr(pkg.np(sd["w"]))

            recovery = pkg.HostPG(timeout=TIMEOUT)
            transport = pkg.PGTransport(recovery, timeout=TIMEOUT,
                                        state_dict_template=lambda: manager.state_dict_template())
            manager = pkg.manager(rid, lh, load_state, lambda state=state: {"w": state["w"]},
                                  use_async_quorum=False, checkpoint_transport=transport)
            try:
                while manager.current_step() < NUM_STEPS:
                    manager.start_quorum()
                    if rid == 1 and manager.current_step() >= 2 and not died:
                        died.append(rid)
                        raise Died()
                    grads = {"g": pkg.arr(np.full(4, 0.1 * (rid + 1)))}
                    avg = manager.allreduce(grads).get_future().wait(30)
                    on_device.append(pkg.is_device(avg["g"]))
                    step = manager.current_step()
                    committed = manager.should_commit()
                    votes.append((step, committed))
                    if committed:
                        # post-vote read: the heal lands during the vote
                        s = float(pkg.np(avg["g"]).sum())
                        state["w"] = state["w"] - s * 0.01 * pkg.arr(np.ones(16))
                done.wait()
                return votes, pkg.np(state["w"]), delivered, on_device
            except Died:
                pass
            finally:
                manager.shutdown(wait=False)
                recovery.shutdown()
        raise RuntimeError("replica exhausted attempts")

    try:
        return _threads(2, replica)
    finally:
        lh.shutdown()


def test_crash_rejoin_heal_votes_as_the_reference():
    ref = _heal_scenario(REF)
    got = _heal_scenario(PORT)
    for r in range(2):
        assert got[r][0] == ref[r][0], (r, got[r][0], ref[r][0])
        np.testing.assert_array_equal(got[r][1], ref[r][1])
        assert all(got[r][3]), "a reduced gradient left the device plane"
    # the crashed step was discarded, the replicas end equal, the rejoiner
    # healed in place
    assert (2, False) in got[0][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert got[1][2] and all(got[1][2])


def _spares_scenario(pkg):
    lh = pkg.lighthouse(min_replicas=3)
    done = threading.Barrier(3, timeout=60)

    def replica(rid):
        manager = pkg.manager(rid, lh, lambda sd: None, lambda: {}, min_replica_size=2,
                              use_async_quorum=False,
                              world_size_mode=pkg.WorldSizeMode.FIXED_WITH_SPARES)
        try:
            manager.start_quorum()
            out = manager.allreduce({"g": pkg.arr(np.full(4, 2.0))}).get_future().wait(30)
            done.wait()
            return manager.num_participants(), manager.is_participating(), pkg.np(out["g"]), \
                pkg.is_device(out["g"])
        finally:
            manager.shutdown(wait=False)

    try:
        return _threads(3, replica)
    finally:
        lh.shutdown()


def test_fixed_with_spares_contributes_zeros_on_the_device():
    """Three replicas, the world pinned at 2: the spare's zeros are in the
    sum and the scale is the pinned world, so every replica gets 2.0."""
    for pkg in (REF, PORT):
        results = _spares_scenario(pkg)
        assert all(n == 2 for n, _p, _g, _d in results), results
        assert sum(1 for _n, p, _g, _d in results if not p) == 1, results
        for _n, _p, g, on_device in results:
            np.testing.assert_array_equal(g, np.full(4, 2.0, np.float32))
            assert on_device


def _allreduce_scenario(pkg, should_quantize, leaves):
    lh = pkg.lighthouse(min_replicas=2)
    done = threading.Barrier(2, timeout=60)

    def replica(rid):
        manager = pkg.manager(rid, lh, lambda sd: None, lambda: {}, use_async_quorum=False)
        try:
            manager.start_quorum()
            grads = {k: pkg.arr(v[rid]) for k, v in leaves.items()}
            out = manager.allreduce(grads, should_quantize=should_quantize) \
                .get_future().wait(30)
            committed = manager.should_commit()
            done.wait()
            assert committed
            assert all(pkg.is_device(v) for v in out.values())
            assert manager._use_async_quorum is False
            return {k: pkg.np(v) for k, v in out.items()}
        finally:
            manager.shutdown(wait=False)

    try:
        return _threads(2, replica)
    finally:
        lh.shutdown()


@pytest.mark.parametrize("should_quantize", [False, True])
@pytest.mark.parametrize("n_leaves", [1, 3])
def test_managed_allreduce_on_the_device_plane_matches_the_reference(should_quantize, n_leaves):
    rng = np.random.RandomState(7 + n_leaves)
    leaves = {f"l{i}": [(rng.randn(300 + 77 * i) * (i + 1)).astype(np.float32)
                        for _ in range(2)] for i in range(n_leaves)}
    ref = _allreduce_scenario(REF, should_quantize, leaves)
    got = _allreduce_scenario(PORT, should_quantize, leaves)
    for r in range(2):
        for k in leaves:
            np.testing.assert_array_equal(got[r][k].view(np.uint32), ref[r][k].view(np.uint32))
    if not should_quantize:
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[0][k], (v[0] + v[1]) / 2)


def test_manager_keeps_the_async_quorum_with_a_device_group():
    """``tests/test_prepare_commit.py``'s ``TestXLAPrepareCommit``: the
    device group's configure is split, so it forces no sync quorum."""
    for pkg in (REF, PORT):
        lh = pkg.lighthouse(min_replicas=1)
        m = pkg.manager(0, lh, lambda sd: None, lambda: {}, use_async_quorum=True)
        try:
            assert m._use_async_quorum is True
            assert m._device_world_epoch == 0
        finally:
            m.shutdown(wait=False)
            lh.shutdown()


def test_wrap_future_arms_the_deadline_at_submission():
    errors = []
    stub = types.SimpleNamespace(_timeout=0.2, report_error=errors.append,
                                 _log=lambda *a: None)
    pending: Future = Future()
    out = Manager.wrap_future(stub, pending, lambda: "zeros", arm_timeout=True)
    assert out.wait(5) == "zeros"
    assert isinstance(errors[0], TimeoutError)
    late: Future = Future()
    out = Manager.wrap_future(stub, late, "zeros", arm_timeout=False)
    assert not out.done()
    late.set_result("value")
    assert out.wait(1) == "value"
    fast: Future = Future()
    out = Manager.wrap_future(stub, fast, "zeros", timeout=5.0)
    fast.set_result("value")
    assert out.wait(1) == "value" and len(errors) == 1


def _diloco_scenario(pkg):
    lh = pkg.lighthouse(min_replicas=2)
    done = threading.Barrier(2, timeout=60)

    def replica(rid):
        state = {"params": {"w": pkg.arr([0.0, 1.0]), "b": pkg.arr([2.0])}}
        manager = pkg.manager(rid, lh, lambda sd: None, lambda: {}, use_async_quorum=False)
        history = []
        try:
            if pkg.port:
                diloco = DiLoCo(manager, state["params"],
                                lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9,
                                                           nesterov=True),
                                sync_every=2, get_params=lambda: state["params"])
            else:
                diloco = RefDiLoCo(manager, state["params"],
                                   optax.sgd(0.7, momentum=0.9, nesterov=True), sync_every=2,
                                   get_params=lambda: state["params"])
            for _ in range(6):
                state["params"] = {k: v - 0.1 * (rid + 1) for k, v in state["params"].items()}
                state["params"] = diloco.step(state["params"])
                history.append({k: pkg.np(v) for k, v in state["params"].items()})
            done.wait()
            return history
        finally:
            manager.shutdown(wait=False)

    try:
        return _threads(2, replica)
    finally:
        lh.shutdown()


def test_diloco_parameter_history_on_the_device_plane():
    ref = _diloco_scenario(REF)
    got = _diloco_scenario(PORT)
    for r in range(2):
        assert len(got[r]) == len(ref[r])
        for g, e in zip(got[r], ref[r]):
            for k in e:
                np.testing.assert_allclose(g[k], e[k], rtol=1e-6, atol=1e-7)
    # the last inner step synced: the replicas agree there
    for k in got[0][-1]:
        np.testing.assert_array_equal(got[0][-1][k], got[1][-1][k])


def _train(plane, quantize):
    cfg = train.TrainConfig(config="debug", seq_len=16, steps=4, quantize=quantize, plane=plane,
                            faults=(train.Fault(1, 2, "crash", at="backward"),))
    return train.run_replicas(cfg, "cpu")


@pytest.mark.parametrize("quantize", [False, True])
def test_trainer_plane_device_crash_and_heal(quantize):
    results = _train("device", quantize)
    assert all(r["step"] == 4 for r in results)
    assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
    assert results[0]["metrics"]["commit_failures"] >= 1
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
    steps = [e for r in results for e in r["log"]]
    assert all(e["wire_bytes_sent"] == 0 for e in steps)
    if not quantize:
        host = _train("host", quantize)
        for k, v in results[0]["params"].items():
            assert torch.equal(v, host[0]["params"][k]), k


def test_trainer_rejects_an_unknown_plane():
    with pytest.raises(ValueError, match="plane"):
        train._make_pg("xla")
