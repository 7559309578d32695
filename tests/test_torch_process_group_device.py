"""The port's device plane (``torchft_tpu_torch/process_group_device.py``)
against the JAX package's ``ProcessGroupXLA`` (``tests/test_process_group_xla.py``).

Local mode: replicas as threads, the reference on the 8 virtual CPU
devices ``tests/conftest.py`` provides (one lead device a replica), the
port on CPU tensors (every replica's lead device the CPU, as every one's
is ``cuda:0`` on one card). The same seeded numpy inputs go through both.
Tolerances: at world 2 every reduction, the packed wire's bytes and the
fp8 allreduce over a device group equal the reference's bit for bit (a
sum of two floats has one rounding in any order). At worlds 3 and 4 the
reference's XLA reduction order is not rank order, so a sum or mean is
held to ``_order_bound``: 2 f32 epsilons times the sum of the addends'
magnitudes, the most two orders of three or four f32 additions can differ
by; MAX and MIN stay exact. The distributed mode runs on gloo in spawned
processes (2 and 3 ranks, each with a ``communicate`` timeout), ports
bound at 0.
"""

import gc
import os
import subprocess
import sys
import textwrap
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from unittest.mock import MagicMock, patch

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu import collectives as ref_coll
from torchft_tpu import process_group as ref_pg
from torchft_tpu.process_group_xla import ProcessGroupXLA
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch import process_group as port_pg
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp
from torchft_tpu_torch.process_group_device import ProcessGroupDevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("SUM", "AVG", "MAX", "MIN", "PRODUCT")
_EPS32 = float(np.finfo(np.float32).eps)


def _order_bound(inputs):
    """The most two orders of an f32 sum (or mean) of ``inputs`` differ by."""
    return 2 * _EPS32 * np.sum(np.abs(np.stack(inputs)), axis=0)


@pytest.fixture()
def store():
    s = KvStoreServer("127.0.0.1:0")
    yield s
    s.shutdown()


def run_parallel(world, fn):
    with ThreadPoolExecutor(max_workers=world) as ex:
        futs = [ex.submit(fn, r) for r in range(world)]
        return [f.result(timeout=60) for f in futs]


def make_pgs(cls, store, world, quorum_id=1, prefix="dev"):
    pgs = [cls(timeout=30.0, mode="local") for _ in range(world)]
    addr = f"127.0.0.1:{store.port}/{prefix}"
    run_parallel(world, lambda r: pgs[r].configure(addr, r, world, quorum_id))
    return pgs


def _both(store, world, run, quorum_id=1):
    """``run(pkg, rank, pg, arr)`` on a world of each package's local-mode
    group: (reference results as numpy, port results as numpy)."""
    out = []
    for port in (False, True):
        pgs = make_pgs(ProcessGroupDevice if port else ProcessGroupXLA, store, world, quorum_id,
                       prefix="port" if port else "ref")
        arr = (lambda a: torch.from_numpy(np.array(a))) if port else jnp.asarray
        op = (lambda name: getattr(ReduceOp, name)) if port else (
            lambda name: getattr(ref_pg.ReduceOp, name))
        res = run_parallel(world, lambda r: run(port, r, pgs[r], arr, op))
        out.append(_to_np(res))
        for pg in pgs:
            pg.shutdown()
    return out


def _to_np(x):
    if isinstance(x, (list, tuple)):
        return [_to_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_matches_reference_bitwise_at_world_two(store, op):
    rng = np.random.RandomState(len(op))
    inputs = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]

    def run(port, r, pg, arr, reduce_op):
        return pg.allreduce([arr(inputs[r])], reduce_op(op)).get_future().wait(30)

    ref, got = _both(store, 2, run)
    for r in range(2):
        np.testing.assert_array_equal(got[r][0].view(np.uint32), ref[r][0].view(np.uint32))


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("op", OPS)
def test_allreduce_matches_reference_within_the_order_bound(store, world, op):
    rng = np.random.RandomState(world * 10 + len(op))
    inputs = [rng.randn(64).astype(np.float32) for _ in range(world)]

    def run(port, r, pg, arr, reduce_op):
        return pg.allreduce([arr(inputs[r])], reduce_op(op)).get_future().wait(30)

    ref, got = _both(store, world, run)
    if op in ("MAX", "MIN"):
        for r in range(world):
            np.testing.assert_array_equal(got[r][0], ref[r][0])
        return
    bound = _order_bound(inputs)
    if op == "AVG":
        bound = bound / world
    if op == "PRODUCT":
        bound = 2 * _EPS32 * world * np.abs(np.prod(np.stack(inputs), axis=0))
    for r in range(world):
        assert np.all(np.abs(got[r][0] - ref[r][0]) <= bound), (op, got[r][0] - ref[r][0])
        np.testing.assert_array_equal(got[r][0], got[0][0])


def test_allreduce_gives_each_rank_its_own_tensor(store):
    world = 3
    pgs = make_pgs(ProcessGroupDevice, store, world)
    outs = run_parallel(world, lambda r: pgs[r].allreduce(
        [torch.full((8,), float(r + 1))], ReduceOp.SUM).get_future().wait(30))
    for out in outs:
        assert isinstance(out[0], torch.Tensor)
        np.testing.assert_array_equal(out[0].numpy(), np.full(8, 6.0, np.float32))
    assert len({out[0].data_ptr() for out in outs}) == world
    # a rank that changes its result changes no other rank's
    outs[0][0].zero_()
    np.testing.assert_array_equal(outs[1][0].numpy(), np.full(8, 6.0, np.float32))


def test_multi_leaf_batched(store):
    rng = np.random.RandomState(3)
    a = [rng.randn(2, 3).astype(np.float32) for _ in range(2)]
    b = [rng.randn(5).astype(np.float32) for _ in range(2)]

    def run(port, r, pg, arr, op):
        return pg.allreduce([arr(a[r]), arr(b[r])], op("SUM")).get_future().wait(30)

    ref, got = _both(store, 2, run)
    for r in range(2):
        for i in range(2):
            np.testing.assert_array_equal(got[r][i], ref[r][i])


def test_allgather_broadcast_as_the_reference(store):
    world = 3
    rng = np.random.RandomState(4)
    inputs = [rng.randn(2, 5).astype(np.float32) for _ in range(world)]

    def run(port, r, pg, arr, op):
        rows = pg.allgather([arr(inputs[r])]).get_future().wait(30)
        bcast = pg.broadcast([arr(inputs[r])], root=1).get_future().wait(30)
        return [rows, bcast]

    ref, got = _both(store, world, run)
    for r in range(world):
        for src in range(world):
            np.testing.assert_array_equal(got[r][0][src][0], ref[r][0][src][0])
            np.testing.assert_array_equal(got[r][0][src][0], inputs[src])
        np.testing.assert_array_equal(got[r][1][0], ref[r][1][0])
        np.testing.assert_array_equal(got[r][1][0], inputs[1])


def test_reduce_scatter_alltoall_as_the_reference(store):
    world = 2
    rng = np.random.RandomState(5)
    chunks = [[rng.randn(6).astype(np.float32) for _ in range(world)] for _ in range(world)]

    def run(port, r, pg, arr, op):
        rs = pg.reduce_scatter([[arr(c)] for c in chunks[r]], op("SUM")).get_future().wait(30)
        a2a = pg.alltoall([arr(c) for c in chunks[r]]).get_future().wait(30)
        return [rs, a2a]

    ref, got = _both(store, world, run)
    for r in range(world):
        np.testing.assert_array_equal(got[r][0][0].view(np.uint32), ref[r][0][0].view(np.uint32))
        for src in range(world):
            np.testing.assert_array_equal(got[r][1][src], ref[r][1][src])
            np.testing.assert_array_equal(got[r][1][src], chunks[src][r])


def test_send_recv(store):
    pgs = make_pgs(ProcessGroupDevice, store, 2)
    payload = torch.arange(4.0)

    def go(r):
        if r == 0:
            return pgs[0].send([payload], dst=1, tag=7).get_future().wait(30)
        return pgs[1].recv(src=0, tag=7).get_future().wait(30)

    res = run_parallel(2, go)
    np.testing.assert_array_equal(res[1][0].numpy(), payload.numpy())
    assert res[1][0].data_ptr() != payload.data_ptr()


def test_reconfigure_smaller_world(store):
    """Quorum change: 4 replicas, one dies, the rest rebuild as 3."""
    pgs = make_pgs(ProcessGroupDevice, store, 4, quorum_id=1)
    outs = run_parallel(4, lambda r: pgs[r].allreduce(
        [torch.ones(2)], ReduceOp.SUM).get_future().wait(30))
    np.testing.assert_array_equal(outs[0][0].numpy(), np.full(2, 4.0, np.float32))
    survivors = pgs[:3]
    addr = f"127.0.0.1:{store.port}/dev"
    run_parallel(3, lambda r: survivors[r].configure(addr, r, 3, 2))
    outs = run_parallel(3, lambda r: survivors[r].allreduce(
        [torch.ones(2)], ReduceOp.SUM).get_future().wait(30))
    np.testing.assert_array_equal(outs[0][0].numpy(), np.full(2, 3.0, np.float32))
    assert survivors[0]._world.world_size == 3
    assert survivors[0].device_world_epoch == 0  # local mode rebuilds nothing


_COLLECTIVES = {
    "allreduce": lambda pg, rank, world, arr: pg.allreduce([arr(np.ones(2, np.float32))]),
    "allgather": lambda pg, rank, world, arr: pg.allgather(
        [arr(np.full(2, float(rank), np.float32))]),
    "broadcast": lambda pg, rank, world, arr: pg.broadcast(
        [arr(np.full(2, float(rank), np.float32))], root=0),
    "reduce_scatter": lambda pg, rank, world, arr: pg.reduce_scatter(
        [[arr(np.full(2, float(rank), np.float32))] for _ in range(world)]),
    "alltoall": lambda pg, rank, world, arr: pg.alltoall(
        [arr(np.full(2, float(rank * 10 + d), np.float32)) for d in range(world)]),
}


@pytest.mark.parametrize("collective", sorted(_COLLECTIVES))
def test_abort_reconfigure_matrix(store, collective):
    """abort -> fail -> reconfigure -> succeed, for every collective, with
    the same outcome in both packages (``test_abort_reconfigure_matrix``)."""
    world = 2
    issue = _COLLECTIVES[collective]
    outcomes = []
    for port in (False, True):
        cls = ProcessGroupDevice if port else ProcessGroupXLA
        arr = (lambda a: torch.from_numpy(np.array(a))) if port else jnp.asarray
        pgs = make_pgs(cls, store, world, prefix=f"{port}_{collective}")
        # rank 0 deposits; rank 1 aborts instead of arriving
        work = issue(pgs[0], 0, world, arr)
        pgs[1].abort()
        with pytest.raises(RuntimeError, match="aborted"):
            work.get_future().wait(10)
        assert pgs[0].errored() is not None
        addr = f"127.0.0.1:{store.port}/{port}_{collective}_again"
        run_parallel(world, lambda r: pgs[r].configure(addr, r, world, 9))
        assert pgs[0].errored() is None
        outs = run_parallel(world, lambda r: issue(pgs[r], r, world, arr).get_future().wait(30))
        outcomes.append(_to_np(outs))
        for pg in pgs:
            pg.shutdown()
    ref, got = outcomes
    flat = lambda x: np.concatenate([np.ravel(v) for v in _flatten(x)])  # noqa: E731
    np.testing.assert_array_equal(flat(got), flat(ref))


def _flatten(x):
    if isinstance(x, list):
        return [leaf for v in x for leaf in _flatten(v)]
    return [x]


def test_a_peer_leaving_after_the_op_leaves_the_survivor_unerrored(store):
    """A replica that shuts down once the op completed (its run ended)
    marks its peer's group errored in the reference, which then discards
    the peer's last step; in the port only the peer's next op fails."""
    for cls in (ProcessGroupXLA, ProcessGroupDevice):
        pgs = make_pgs(cls, store, 2, prefix=f"leave_{cls.__name__}")
        arr = jnp.asarray if cls is ProcessGroupXLA else torch.from_numpy
        run_parallel(2, lambda r: pgs[r].allreduce([arr(np.ones(2, np.float32))])
                     .get_future().wait(30))
        pgs[1].shutdown()
        if cls is ProcessGroupXLA:
            assert pgs[0].errored() is not None
        else:
            assert pgs[0].errored() is None
            with pytest.raises(RuntimeError, match="aborted"):
                pgs[0].allreduce([torch.ones(2)]).get_future().wait(10)
        pgs[0].shutdown()


def test_abort_keeps_no_frame_of_the_aborting_thread(store):
    """A replica that aborts its group while a peer's op is pending (a crash
    after its backward pass) is released once it returns: nothing the
    failure raises on the peer's side keeps the aborting thread's frames,
    and with them its Manager and model."""
    pgs = make_pgs(ProcessGroupDevice, store, 2)
    work = pgs[0].allreduce([torch.ones(4)])
    failed = []

    def on_done(f):
        # the peer's Manager reads the failure where it runs, as
        # wrap_future does, and keeps the exception (and its traceback)
        try:
            f.value()
        except RuntimeError as e:
            failed.append(e)

    work.get_future().add_done_callback(on_done)

    class Model:
        pass

    def crashing_replica():
        model = Model()  # noqa: F841 - held by this frame only
        ref = weakref.ref(model)
        pgs[1].abort()
        return ref

    holder = {}
    t = threading.Thread(target=lambda: holder.update(ref=crashing_replica()))
    t.start()
    t.join(10)
    with pytest.raises(RuntimeError, match="aborted"):
        work.get_future().wait(10)
    try:
        work.get_future().value()
    except RuntimeError:
        pass
    gc.collect()
    assert failed and holder["ref"]() is None


def test_prepare_shrink_as_the_reference(store):
    """Local mode: the commit poisons the generation and re-lands the same
    coordinates on a fresh one; an unconfigured group has nothing to fence;
    distributed mode raises."""
    assert ProcessGroupDevice(mode="local").prepare_shrink(1) is None
    assert ProcessGroupXLA(mode="local").prepare_shrink(1) is None
    for cls in (ProcessGroupXLA, ProcessGroupDevice):
        pgs = make_pgs(cls, store, 2, prefix=f"shrink_{cls.__name__}")
        old = pgs[0]._world
        commit = pgs[0].prepare_shrink(dead_group_rank=1)
        assert commit is not None and pgs[0]._world is old
        commit()
        assert old.error is not None and pgs[0]._world is not old
        assert pgs[0].errored() is None
        for pg in pgs:
            pg.shutdown()
    pg = ProcessGroupDevice(mode="distributed")
    pg._world = MagicMock(distributed=True)
    pg._last_configure = ("x:1/p", 0, 2, 1)
    with pytest.raises(RuntimeError, match="leave-heal-rejoin"):
        pg.prepare_shrink(1)


def test_modes_and_sync_quorum():
    """``auto`` resolves to local (the reference's :540-550); neither mode
    forces the Manager's sync quorum (``tests/test_prepare_commit.py``'s
    ``TestXLAPrepareCommit``)."""
    assert ProcessGroupDevice().mode == "local"
    assert ProcessGroupDevice(mode="distributed").mode == "distributed"
    assert ProcessGroupDevice(mode="local").requires_sync_quorum is False
    assert ProcessGroupXLA(mode="local").requires_sync_quorum is False
    assert ProcessGroupDevice.device_native and ProcessGroupXLA.device_native
    with pytest.raises(ValueError, match="mode"):
        ProcessGroupDevice(mode="xla")


def test_distributed_prepare_defers_the_group_build():
    """Distributed prepare does only the rendezvous; the retire, the group
    build and the install run in the commit, in both packages."""
    for mod, cls in (("torchft_tpu.process_group_xla", ProcessGroupXLA),
                     ("torchft_tpu_torch.process_group_device", ProcessGroupDevice)):
        pg = cls(timeout=5.0, mode="distributed")
        stage = ([] if cls is ProcessGroupXLA
                 else [patch.object(cls, "_stage_distributed", return_value=MagicMock())])
        with patch(f"{mod}.KvClient") as kv_cls, \
                patch.object(cls, "_retire_current_world") as retire, \
                patch.object(cls, "_configure_distributed") as cfg, \
                patch.object(cls, "_install_world") as install:
            for p in stage:
                p.start()
            try:
                cfg.return_value = MagicMock()
                commit = pg.prepare_configure("127.0.0.1:1/pgxla", 0, 2, quorum_id=3)
                assert commit is not None
                if cls is ProcessGroupXLA:
                    kv_cls.return_value.set.assert_called_once()  # rank 0 publishes
                retire.assert_not_called()
                cfg.assert_not_called()
                install.assert_not_called()
                commit()
                retire.assert_called_once()
                cfg.assert_called_once()
                install.assert_called_once()
            finally:
                for p in stage:
                    p.stop()


def test_fake_wrapper_forwards_device_native():
    for pkg, native in ((ref_pg, ProcessGroupXLA), (port_pg, ProcessGroupDevice)):
        assert pkg.FakeProcessGroupWrapper(native(mode="local")).device_native
        assert pkg.ErrorSwallowingProcessGroupWrapper(native(mode="local")).device_native
        assert not pkg.FakeProcessGroupWrapper(pkg.ProcessGroupDummy()).device_native


# ------------------------------------------------------- the packed wire
def _quantized(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 3).astype(np.float32)


@pytest.mark.parametrize("n", [512 * 3, 700, 5000])
def test_packed_wire_bytes_equal_the_reference(n):
    from torchft_tpu.ops.quantization import fused_quantize_fp8 as ref_quantize
    from torchft_tpu_torch.ops.quantization import fused_quantize_fp8

    x = _quantized(n, n)
    q_ref, s_ref, _ = ref_quantize(jnp.asarray(x), 512)
    q, s, _ = fused_quantize_fp8(torch.from_numpy(x))
    ref_bytes = np.asarray(ref_coll._pack_wire_device(q_ref, s_ref))
    got = tcoll._pack_wire_device(q, s)
    assert got.dtype == torch.uint8 and got.dim() == 1
    np.testing.assert_array_equal(got.numpy(), ref_bytes)
    rows = q.shape[0]
    deq_ref = np.asarray(ref_coll._unpack_dequant_device([ref_bytes, ref_bytes], rows, 512))
    deq = tcoll._unpack_dequant_device([got, got], rows)
    np.testing.assert_array_equal(deq.numpy().view(np.uint32), deq_ref.view(np.uint32))


@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("fn", ["allreduce_quantized", "reduce_scatter_quantized"])
def test_quantized_over_a_device_group_matches_the_reference_bitwise(store, op, fn):
    """World 2: the port's device engine over a ProcessGroupDevice (the
    packed device wire) against the reference's over ProcessGroupXLA, and
    against the port's own over a ProcessGroupHost (the tuple wire): the
    same codes, so the same bits."""
    world = 2
    inputs = [[_quantized(1000, 11 + r), _quantized(37, 21 + r)] for r in range(world)]

    def run(port, r, pg, arr, reduce_op):
        coll = tcoll if port else ref_coll
        return getattr(coll, fn)([arr(a) for a in inputs[r]], reduce_op(op), pg) \
            .get_future().wait(60)

    ref, got = _both(store, world, run, quorum_id=4)
    pgs = [ProcessGroupHost(timeout=30.0) for _ in range(world)]
    addr = f"127.0.0.1:{store.port}/host"
    run_parallel(world, lambda r: pgs[r].configure(addr, r, world, 4))
    host = _to_np(run_parallel(world, lambda r: getattr(tcoll, fn)(
        [torch.from_numpy(a) for a in inputs[r]], getattr(ReduceOp, op), pgs[r])
        .get_future().wait(60)))
    for pg in pgs:
        pg.shutdown()
    for r in range(world):
        for a, b, c in zip(_flatten(got[r]), _flatten(ref[r]), _flatten(host[r])):
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
            np.testing.assert_array_equal(a.view(np.uint32), c.view(np.uint32))


def test_numpy_inputs_over_a_device_group_are_refused(store):
    pgs = make_pgs(ProcessGroupDevice, store, 2)
    with pytest.raises(TypeError, match="device-native"):
        tcoll.allreduce_quantized([np.ones(8, np.float32)], ReduceOp.SUM, pgs[0])


# --------------------------------------------------- the distributed mode
_DIST_WORKER = textwrap.dedent(r"""
    import sys, time
    rank = int(sys.argv[1]); world = int(sys.argv[2]); store_port = sys.argv[3]
    scenario = sys.argv[4]
    sys.path.insert(0, {repo!r})
    import torch
    from torchft_tpu_torch.process_group import ReduceOp
    from torchft_tpu_torch.process_group_device import ProcessGroupDevice

    pg = ProcessGroupDevice(timeout=20.0, mode="distributed")
    addr = f"127.0.0.1:{{store_port}}/dist"
    pg.configure(addr, rank, world, quorum_id=1)
    out = pg.allreduce([torch.full((4,), float(rank + 1))], ReduceOp.SUM).get_future().wait(20)
    assert torch.equal(out[0], torch.full((4,), world * (world + 1) / 2)), out
    rows = pg.allgather([torch.full((2,), float(rank))]).get_future().wait(20)
    assert [float(r[0][0]) for r in rows] == [float(s) for s in range(world)], rows
    col = pg.alltoall([torch.full((2,), float(10 * rank + d)) for d in range(world)]) \
        .get_future().wait(20)
    assert [float(c[0]) for c in col] == [float(10 * s + rank) for s in range(world)], col
    rs = pg.reduce_scatter([[torch.full((2,), float(rank + d))] for d in range(world)],
                           ReduceOp.AVG).get_future().wait(20)
    assert float(rs[0][0]) == sum(s + rank for s in range(world)) / world, rs
    b = pg.broadcast([torch.full((2,), float(rank))], root=1).get_future().wait(20)
    assert float(b[0][0]) == 1.0, b
    print(f"RANK{{rank}} WORLD{{world}} OK epoch={{pg.device_world_epoch}}", flush=True)

    if scenario == "reconfigure":
        # rank world-1 leaves; the others rebuild as world-1, in process
        if rank == world - 1:
            pg.shutdown()
            sys.exit(0)
        pg.configure(addr, rank, world - 1, quorum_id=2)
        out = pg.allreduce([torch.full((4,), 10.0 * (rank + 1))], ReduceOp.SUM) \
            .get_future().wait(20)
        assert torch.equal(out[0], torch.full((4,), 10.0 * (world - 1) * world / 2)), out
        print(f"RANK{{rank}} RECONFIGURED OK epoch={{pg.device_world_epoch}}", flush=True)
    elif scenario == "abort":
        if rank == 0:
            time.sleep(0.5)
            t0 = time.monotonic()
            pg.abort()
            assert pg.errored() is not None
            print(f"RANK{{rank}} ABORTED OK in {{time.monotonic() - t0:.3f}} s", flush=True)
            time.sleep(6.0)  # alive: the peer must fail by its timeout, not a closed socket
        else:
            t0 = time.monotonic()
            try:
                pg.allreduce([torch.ones(4)], ReduceOp.SUM).get_future().wait(30)
                print(f"RANK{{rank}} UNEXPECTED SUCCESS", flush=True)
            except BaseException as e:
                print(f"RANK{{rank}} OP FAILED AS EXPECTED after "
                      f"{{time.monotonic() - t0:.1f}} s: {{type(e).__name__}}", flush=True)
    pg.shutdown()
""")


def _spawn_dist(store, world, scenario, timeout=60, heartbeat_s=None):
    script = _DIST_WORKER.format(repo=REPO)
    env = dict(os.environ)
    if heartbeat_s is not None:
        env["TORCHFT_XLA_HEARTBEAT_SEC"] = str(heartbeat_s)
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(store.port),
                          scenario], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for r in range(world)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n<TIMEOUT>"
        outs.append(out)
    return outs


def test_distributed_allreduce_and_reconfigure_on_gloo(store):
    outs = _spawn_dist(store, 3, "reconfigure")
    for r in range(3):
        assert f"RANK{r} WORLD3 OK epoch=1" in outs[r], outs[r]
    for r in range(2):
        assert f"RANK{r} RECONFIGURED OK epoch=2" in outs[r], outs[r]


def test_distributed_abort_unblocks_peer_on_gloo(store):
    """gloo has no abort: the aborting rank returns at once, and its peer's
    pending op fails by the group's timeout (TORCHFT_XLA_HEARTBEAT_SEC, 3 s
    here) while the aborting process is still alive, instead of hanging."""
    outs = _spawn_dist(store, 2, "abort", heartbeat_s=3)
    assert "RANK0 ABORTED OK" in outs[0], outs[0]
    took = float(outs[0].split("ABORTED OK in ")[1].split()[0])
    assert took < 5.0, outs[0]
    assert "RANK1 OP FAILED AS EXPECTED" in outs[1] and "<TIMEOUT>" not in outs[1], outs[1]
    failed_after = float(outs[1].split("EXPECTED after ")[1].split()[0])
    assert failed_after < 3.0 + 5.0, outs[1]


def test_device_module_imports_no_jax_and_no_nccl_at_import():
    """The module imports on a CPU-only torch: no JAX, nothing of the JAX
    package, and no NCCL class at module level."""
    import ast

    path = os.path.join(REPO, "torchft_tpu_torch", "process_group_device.py")
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "torchft_tpu"}
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("NCCL" in a.name for n in top for a in n.names)
