"""The port's process-group wrappers against the JAX package's:
``ErrorSwallowingProcessGroupWrapper`` (``tests/test_process_group.py``'s
cases, alone and over the fault-injecting fake PG), and
``ManagedProcessGroup`` over a real Manager (two replica threads, a
lighthouse that wants both), each scenario run on both packages with equal
results.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu import process_group as ref_pg
from torchft_tpu.coordination import LighthouseServer as RefLighthouse
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu_torch import process_group as port_pg
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager

PKGS = pytest.mark.parametrize("pg", [ref_pg, port_pg], ids=["reference", "port"])


@PKGS
def test_error_swallowing(pg):
    wrapped = pg.ErrorSwallowingProcessGroupWrapper(pg.ProcessGroupDummy())
    out = wrapped.allreduce([np.array([5.0])]).get_future().wait()
    np.testing.assert_allclose(out[0], [5.0])
    assert wrapped.error() is None
    wrapped.report_error(RuntimeError("injected"))
    # after an error every op resolves to its input
    out = wrapped.allreduce([np.array([7.0])]).get_future().wait()
    np.testing.assert_allclose(out[0], [7.0])
    assert wrapped.errored() is not None
    wrapped.configure("ignored:0/x", 0, 1)
    assert wrapped.error() is None


@PKGS
def test_error_swallowing_over_fake(pg):
    fake = pg.FakeProcessGroupWrapper(pg.ProcessGroupDummy())
    wrapped = pg.ErrorSwallowingProcessGroupWrapper(fake)
    fake.report_future_error(RuntimeError("boom"))
    out = wrapped.allreduce([np.array([3.0])]).get_future().wait()
    np.testing.assert_allclose(out[0], [3.0])
    assert wrapped.error() is not None
    # every later op is the identity too, alltoall and allgather included
    np.testing.assert_allclose(
        wrapped.alltoall([np.array([1.0]), np.array([2.0])]).get_future().wait()[1], [2.0])
    assert len(wrapped.allgather([np.array([4.0])]).get_future().wait()) == 1


def test_error_swallowing_stages_tensors_to_the_host():
    """After an error the port's identity of a tensor is its host copy, as
    the reference's of a jax array (bf16 stays a CPU tensor)."""
    wrapped = port_pg.ErrorSwallowingProcessGroupWrapper(port_pg.ProcessGroupDummy())
    wrapped.report_error(RuntimeError("x"))
    f32, bf16 = torch.arange(3.0), torch.ones(2, dtype=torch.bfloat16)
    out = wrapped.allreduce([f32, bf16]).get_future().wait()
    np.testing.assert_array_equal(out[0], f32.numpy())
    assert isinstance(out[1], torch.Tensor) and out[1].dtype == torch.bfloat16


@PKGS
def test_error_swallowing_forwards_device_native(pg):
    class Native(pg.ProcessGroupDummy):
        device_native = True

    assert pg.ErrorSwallowingProcessGroupWrapper(Native()).device_native
    assert not pg.ErrorSwallowingProcessGroupWrapper(pg.ProcessGroupDummy()).device_native


@PKGS
def test_managed_process_group_rank_before_the_first_quorum(pg):
    class Stub:
        def replica_rank(self):
            return None

        def num_participants(self):
            return 0

    managed = pg.ManagedProcessGroup(Stub())
    assert managed.rank() == 0 and managed.size() == 0
    for op in (lambda: managed.allgather([np.ones(1)]),
               lambda: managed.alltoall([np.ones(1)]),
               lambda: managed.send([np.ones(1)], 0),
               lambda: managed.recv(0)):
        with pytest.raises(NotImplementedError, match="only routes allreduce"):
            op()
    with pytest.raises(RuntimeError, match="configured by its Manager"):
        managed.configure("s:1/x", 0, 1)


def _managed_allreduce(port: bool):
    """Two replica threads, each a Manager over its own host PG; a
    ManagedProcessGroup's AVG allreduce of each replica's leaves for two
    steps. Returns each replica's results as numpy, with the managed PG's
    rank and size."""
    pg_mod = port_pg if port else ref_pg
    lh = (LighthouseServer if port else RefLighthouse)(
        bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000, quorum_tick_ms=20,
        heartbeat_timeout_ms=3000)
    state = [{"w": np.full(3, float(r), np.float32)} for r in range(2)]

    def replica(rid: int):
        manager = (Manager if port else RefManager)(
            pg=pg_mod.ProcessGroupHost(timeout=20.0), load_state_dict=lambda sd: None,
            state_dict=lambda: state[rid], min_replica_size=2, replica_id=f"managed_{rid}",
            lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=20.0, quorum_timeout=20.0)
        managed = pg_mod.ManagedProcessGroup(manager)
        out = []
        try:
            for step in range(2):
                manager.start_quorum()
                leaves = [np.arange(6, dtype=np.float32) * (rid + 1) + step,
                          np.full((2, 2), 0.25 * rid, np.float32)]
                if port:
                    leaves = [torch.from_numpy(a) for a in leaves]
                res = managed.allreduce(leaves, op=pg_mod.ReduceOp.AVG).get_future().wait(20)
                out.append([np.array(x.numpy() if isinstance(x, torch.Tensor) else x)
                            for x in res])
                out.append((managed.rank(), managed.size()))
                assert manager.should_commit()
            return out
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return [f.result(timeout=60) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def test_managed_process_group_over_a_manager_as_the_reference():
    ref, port = _managed_allreduce(False), _managed_allreduce(True)
    for r in range(2):
        for a, b in zip(ref[r], port[r]):
            if isinstance(a, tuple):
                assert a == b
            else:
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    # step 1 (the init_sync heal sits a replica out of step 0): the AVG over
    # both replicas, and the quorum's ranks
    np.testing.assert_allclose(port[0][2][0], np.arange(6) * 1.5 + 1)
    assert sorted(port[r][1][0] for r in range(2)) == [0, 1]
    assert port[0][1][1] == 2
