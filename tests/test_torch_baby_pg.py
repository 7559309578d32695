"""The port's subprocess-isolated (Baby) process groups against the JAX
package's: the reference's ``tests/test_baby_pg.py`` scenarios on the
port (the monitored pipe, the thread-backed context, threaded
collectives, draining, shutdown, a spawned child killed and the group
reconfigured, the register/fail race, abort reaching the inner group),
results compared with the reference's Baby on the same arrays; the
windowed ``PGTransport`` wire over Baby groups, spawned children killed
mid-heal; and the trainer's ``pg-baby`` transport through a crash whose
heal loses its source's child."""

import multiprocessing as mp
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.coordination import KvStoreServer as RefStore
from torchft_tpu.multiprocessing_dummy_context import DummyContext as RefDummyContext
from torchft_tpu.process_group import ProcessGroupBabyHost as RefBaby
from torchft_tpu.process_group import ReduceOp as RefReduceOp
from torchft_tpu_torch.checkpointing import PGTransport
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.multiprocessing import _MonitoredPipe
from torchft_tpu_torch.multiprocessing_dummy_context import DummyContext
from torchft_tpu_torch.process_group import (
    ProcessGroupBabyHost,
    ProcessGroupHost,
    ReduceOp,
    _pipe_in,
    _pipe_out,
)


@pytest.fixture()
def store():
    s = KvStoreServer("127.0.0.1:0")
    yield s
    s.shutdown()


def run_parallel(world, fn):
    with ThreadPoolExecutor(max_workers=world) as ex:
        futs = [ex.submit(fn, r) for r in range(world)]
        return [f.result(timeout=120) for f in futs]


def make_pgs(cls, store, world, ctx, prefix, quorum_id=1, timeout=20.0):
    pgs = [cls(timeout=timeout, ctx=ctx) for _ in range(world)]
    addr = f"127.0.0.1:{store.port}/{prefix}"
    run_parallel(world, lambda r: pgs[r].configure(addr, r, world, quorum_id))
    return pgs


def both_packages(world, fn, prefix):
    """``fn(pgs, reduce_op_module)`` on threaded Baby groups of the port,
    then of the reference; returns (port's, reference's)."""
    out = []
    for cls, store_cls, ctx_cls, ops in ((ProcessGroupBabyHost, KvStoreServer, DummyContext,
                                          ReduceOp),
                                         (RefBaby, RefStore, RefDummyContext, RefReduceOp)):
        s = store_cls("127.0.0.1:0")
        pgs = make_pgs(cls, s, world, ctx_cls(), prefix)
        try:
            out.append(fn(pgs, ops))
        finally:
            for pg in pgs:
                pg.shutdown()
            s.shutdown()
    return out


def assert_same_tree(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


class TestMonitoredPipe:
    def test_roundtrip_and_timeout(self):
        a, b = DummyContext().Pipe()
        pa, pb = _MonitoredPipe(a), _MonitoredPipe(b)
        pa.send({"x": 1})
        assert pb.recv(1.0) == {"x": 1}
        with pytest.raises(TimeoutError):
            pb.recv(0.05)

    def test_exception_passthrough(self):
        a, b = DummyContext().Pipe()
        pa, pb = _MonitoredPipe(a), _MonitoredPipe(b)
        pa.send(ValueError("shipped"))
        with pytest.raises(ValueError, match="shipped"):
            pb.recv(1.0)

    def test_close_raises_eof(self):
        a, b = DummyContext().Pipe()
        pb = _MonitoredPipe(b)
        a.close()
        with pytest.raises(EOFError):
            pb.recv(1.0)

    def test_real_pipe_carries_buffers_out_of_band(self):
        """Over a multiprocessing Connection: arrays of 64 MiB and a bf16
        tensor's bits cross intact, an exception is raised, and a closed
        peer reads as EOF."""
        a, b = mp.get_context("spawn").Pipe()
        pa, pb = _MonitoredPipe(a), _MonitoredPipe(b)
        big = (np.arange(64 << 20) % 253).astype(np.uint8)
        bf16 = torch.randn(1000, generator=torch.Generator().manual_seed(0)).bfloat16()
        msg = ("func", 3, "send", _pipe_out([[big, np.float32(2.5), bf16]]), {"k": (1, "x")})
        # the writer blocks until the reader drains the pipe
        t = threading.Thread(target=pa.send, args=(msg,))
        t.start()
        got = pb.recv(30.0)
        t.join(30.0)
        assert got[:3] == ("func", 3, "send") and got[4] == {"k": (1, "x")}
        arrays = _pipe_in(got[3])[0]
        np.testing.assert_array_equal(arrays[0], big)
        assert arrays[0].flags.writeable
        assert arrays[1] == np.float32(2.5)
        assert arrays[2].dtype == torch.bfloat16 and torch.equal(arrays[2], bf16)
        pa.send(RuntimeError("from the child"))
        with pytest.raises(RuntimeError, match="from the child"):
            pb.recv(5.0)
        pa.close()
        with pytest.raises(EOFError):
            pb.recv(5.0)
        pb.close()

    def test_pipe_refuses_cuda_and_card_coded_wires(self):
        from torchft_tpu_torch.ops.quantization import CompressedWire

        wire = CompressedWire("fp8", np.zeros((1, 512), np.uint8), np.ones(1, np.float32), 512,
                              "float32", 512, device="cuda:0")
        with pytest.raises(TypeError, match="never touches the card"):
            _pipe_out([wire])
        host = wire._replace(device=None)
        assert _pipe_in(_pipe_out([host]))[0] is host


class TestDummyContext:
    def test_process_runs_and_joins(self):
        out = []
        p = DummyContext().Process(target=lambda v: out.append(v), args=(7,))
        p.start()
        p.join(5.0)
        assert not p.is_alive() and p.exitcode == 0 and out == [7]

    def test_process_failure_exitcode(self):
        def boom():
            raise RuntimeError("x")

        p = DummyContext().Process(target=boom)
        p.start()
        p.join(5.0)
        assert p.exitcode == 1

    def test_crashed_child_eofs_connections(self):
        local, remote = DummyContext().Pipe()

        def boom(conn):
            raise RuntimeError("worker died")

        p = DummyContext().Process(target=boom, args=(remote,))
        p.start()
        p.join(5.0)
        with pytest.raises(EOFError):
            local.recv()

    def test_poll_none_blocks_until_data(self):
        local, remote = DummyContext().Pipe()
        t = threading.Timer(0.2, lambda: remote.send("late"))
        t.start()
        assert local.poll(None) is True
        assert local.recv() == "late"


class TestBabyThreaded:
    def test_allreduce_matches_the_reference(self):
        world = 3
        rng = np.random.RandomState(0)
        xs = [[rng.randn(5, 3).astype(np.float32), rng.randint(0, 9, 7).astype(np.int64)]
              for _ in range(world)]

        def run(pgs, ops):
            return run_parallel(world, lambda r: pgs[r].allreduce(
                xs[r], ops.SUM).get_future().wait(30))

        port, ref = both_packages(world, run, "allreduce")
        assert_same_tree(port, ref)
        np.testing.assert_allclose(port[0][0], sum(x[0] for x in xs), rtol=1e-6)

    def test_collectives_match_the_reference(self):
        world = 2

        def run(pgs, ops):
            def one(r):
                x = np.full((2,), float(r), dtype=np.float32)
                bc = pgs[r].broadcast([x], root=1).get_future().wait(30)
                ag = pgs[r].allgather([x]).get_future().wait(30)
                a2a = pgs[r].alltoall([np.array([r * 10 + j], dtype=np.float32)
                                       for j in range(world)]).get_future().wait(30)
                rs = pgs[r].reduce_scatter(
                    [[np.full((3,), float(r * 10 + j), np.float32)] for j in range(world)],
                    ops.SUM).get_future().wait(30)
                return bc, ag, a2a, rs

            return run_parallel(world, one)

        port, ref = both_packages(world, run, "collectives")
        assert_same_tree(port, ref)
        for r, (bc, ag, a2a, rs) in enumerate(port):
            np.testing.assert_array_equal(bc[0], np.ones(2, np.float32))
            np.testing.assert_array_equal(a2a[1], [10 + r])
            np.testing.assert_array_equal(rs[0], np.full(3, 0 * 10 + r + 1 * 10 + r, np.float32))

    def test_bf16_allreduce_matches_the_host_group(self, store):
        """bf16 tensors cross the pipe as their bits and sum as the host
        group sums them (CPU torch bf16)."""
        world = 2
        xs = [torch.randn(300, generator=torch.Generator().manual_seed(r)).bfloat16()
              for r in range(world)]
        babies = make_pgs(ProcessGroupBabyHost, store, world, DummyContext(), "bf16_baby")
        hosts = [ProcessGroupHost(timeout=20.0) for _ in range(world)]
        addr = f"127.0.0.1:{store.port}/bf16_host"
        run_parallel(world, lambda r: hosts[r].configure(addr, r, world, 1))
        try:
            got = run_parallel(world, lambda r: babies[r].allreduce([xs[r]]).get_future().wait(30))
            want = run_parallel(world, lambda r: hosts[r].allreduce([xs[r]]).get_future().wait(30))
        finally:
            for pg in babies + hosts:
                pg.shutdown()
        for g, w in zip(got, want):
            assert g[0].dtype == torch.bfloat16 and torch.equal(g[0], w[0])

    def test_num_active_work_drains(self, store):
        world = 2
        pgs = make_pgs(ProcessGroupBabyHost, store, world, DummyContext(), "drain")
        try:
            run_parallel(world, lambda r: pgs[r].allreduce(
                [np.ones((2,), dtype=np.float32)], ReduceOp.SUM).get_future().wait(30))
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and any(pg.num_active_work() for pg in pgs):
                time.sleep(0.01)
            assert all(pg.num_active_work() == 0 for pg in pgs)
        finally:
            for pg in pgs:
                pg.shutdown()

    def test_shutdown_fails_outstanding(self, store):
        pgs = make_pgs(ProcessGroupBabyHost, store, 2, DummyContext(), "shutdown")
        # rank 0's collective cannot complete (its peer never joins it)
        w = pgs[0].allreduce([np.ones((2,), dtype=np.float32)])
        pgs[0].shutdown()
        with pytest.raises(Exception):
            w.get_future().wait(10)
        pgs[1].shutdown()


class _AbortRecordingPG:
    """An inner group that records abort() (shared memory under threads)."""

    aborted: list = []

    def __init__(self, timeout=60.0):
        pass

    def configure(self, store_addr, rank, world, quorum_id=0):
        pass

    def abort(self):
        _AbortRecordingPG.aborted.append(True)

    def shutdown(self):
        pass


class _BabyAbortStub(ProcessGroupBabyHost):
    PG_CLASS = _AbortRecordingPG


class TestRegressions:
    def test_submit_after_fail_gen_resolves_promptly(self, store):
        """A future registered after _fail_gen swapped the table fails at
        once instead of waiting out its timeout."""
        pgs = make_pgs(ProcessGroupBabyHost, store, 2, DummyContext(), "race")
        try:
            gen = pgs[0]._gen
            orig_send = gen.req.send

            def dying_send(msg):
                pgs[0]._fail_gen(gen, RuntimeError("child died mid-send"))
                orig_send(msg)

            gen.req.send = dying_send
            t0 = time.perf_counter()
            work = pgs[0].allreduce([np.ones(4, np.float32)], ReduceOp.SUM)
            with pytest.raises(RuntimeError, match="child died mid-send"):
                work.get_future().wait(10.0)
            assert time.perf_counter() - t0 < 5.0
        finally:
            for pg in pgs:
                pg.shutdown()

    def test_abort_reaches_inner_pg_under_dummy_context(self, store):
        _AbortRecordingPG.aborted.clear()
        pg = _BabyAbortStub(timeout=5.0, ctx=DummyContext())
        pg.configure(f"127.0.0.1:{store.port}/abort_stub", 0, 1, 1)
        assert not _AbortRecordingPG.aborted
        pg.abort()
        deadline = time.perf_counter() + 5.0
        while not _AbortRecordingPG.aborted and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert _AbortRecordingPG.aborted
        assert pg.errored() is not None
        pg.shutdown()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "user": {"w": torch.randn(64, 33, generator=g), "b": torch.randn(7, generator=g).bfloat16(),
                 "big": torch.randn(300_000, generator=g), "n": torch.arange(5)},
        "torchft": {"step": 4, "batches_committed": 8},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


def _heal(pgs, state, template=None, timeout=20.0):
    sender = PGTransport(pgs[0], timeout=timeout)
    receiver = PGTransport(pgs[1], timeout=timeout,
                           state_dict_template=None if template is None else lambda: template)
    with ThreadPoolExecutor(max_workers=2) as ex:
        fs = ex.submit(sender.send_checkpoint, [1], 4, state, timeout)
        fr = ex.submit(receiver.recv_checkpoint, 0, "<pg_transport>", 4, timeout)
        errors = []
        for f in (fs, fr):
            try:
                f.result(timeout=120)
            except Exception as e:  # noqa: BLE001 - the caller reads them
                errors.append(e)
        return (fr.result() if not errors else None), errors


def _assert_state_equal(a, b):
    for k in a["user"]:
        assert a["user"][k].dtype == b["user"][k].dtype
        assert torch.equal(a["user"][k], b["user"][k]), k
    assert a["torchft"] == b["torchft"]


class TestPGTransportOverBaby:
    def test_windowed_wire_over_baby_pgs(self, store):
        """No raw frames: the per-leaf windowed wire on both sides, landing
        in place in the receiver's template."""
        pgs = make_pgs(ProcessGroupBabyHost, store, 2, DummyContext(), "ckpt_baby", quorum_id=11)
        try:
            assert not pgs[0].streams_raw_frames
            state = _state()
            template = _zeros_like(state)
            out, errors = _heal(pgs, state, template)
            assert not errors
            _assert_state_equal(state, out)
            assert out["user"]["w"] is template["user"]["w"]
        finally:
            for pg in pgs:
                pg.shutdown()

    def test_spawned_children_heal_through_a_killed_source_child(self, store):
        """Spawned children: a heal whose source child is SIGKILLed after
        its second leaf fails on both sides with errored() set, nothing
        left alive; the next generation (fresh children) heals bitwise,
        and shutdown reaps every child."""
        ctx = mp.get_context("spawn")
        pgs = [ProcessGroupBabyHost(timeout=20.0, ctx=ctx) for _ in range(2)]
        addr = f"127.0.0.1:{store.port}/spawn_heal"
        try:
            run_parallel(2, lambda r: pgs[r].configure(addr, r, 2, 1))
            first = [pg._gen.proc.pid for pg in pgs]
            send, sent = pgs[0].send, [0]

            def send_then_kill(arrays, dst, tag=0):
                work = send(arrays, dst, tag)
                sent[0] += tag == 2
                if sent[0] == 2:
                    pgs[0]._gen.proc.kill()
                return work

            pgs[0].send = send_then_kill
            state = _state(1)
            template = _zeros_like(state)
            out, errors = _heal(pgs, state, template)
            assert out is None and len(errors) == 2
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and not all(pg.errored() for pg in pgs):
                time.sleep(0.01)
            assert all(pg.errored() is not None for pg in pgs)
            del pgs[0].send
            run_parallel(2, lambda r: pgs[r].configure(addr, r, 2, 2))
            assert all(pg._gen.proc.pid not in first for pg in pgs)
            assert all(pg.errored() is None for pg in pgs)
            out, errors = _heal(pgs, state, template)
            assert not errors
            _assert_state_equal(state, out)
            assert out["user"]["big"] is template["user"]["big"]
        finally:
            for pg in pgs:
                pg.shutdown()
        assert mp.active_children() == []

    def test_spawn_allreduce_kill_and_reconfigure(self, store):
        """The reference's spawn scenario on the port: an allreduce across
        two spawned children, one killed, errored(), both reconfigured,
        the collective works again."""
        ctx = mp.get_context("spawn")
        pgs = [ProcessGroupBabyHost(timeout=60.0, ctx=ctx) for _ in range(2)]
        addr = f"127.0.0.1:{store.port}/spawn"
        try:
            run_parallel(2, lambda r: pgs[r].configure(addr, r, 2, 1))

            def run(r):
                x = np.full((8,), float(r + 1), dtype=np.float32)
                return pgs[r].allreduce([x], ReduceOp.SUM).get_future().wait(60)

            for out in run_parallel(2, run):
                np.testing.assert_allclose(out[0], np.full((8,), 3.0))
            pgs[1]._gen.proc.kill()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and pgs[1].errored() is None:
                time.sleep(0.05)
            assert pgs[1].errored() is not None
            run_parallel(2, lambda r: pgs[r].configure(addr, r, 2, 2))
            for out in run_parallel(2, run):
                np.testing.assert_allclose(out[0], np.full((8,), 3.0))
        finally:
            for pg in pgs:
                pg.shutdown()
        assert mp.active_children() == []


def test_trainer_heals_over_baby_through_a_killed_child():
    """``transport="pg-baby"``: replica 1 crashes after step 1's backward
    pass and heals through its Baby child; its crash at step 3 has the
    source's child killed two leaves into the heal: both Babies show
    errored() within the recovery timeout, the step is discarded, the
    next quorum heals on fresh children, and the replicas end bitwise
    equal with no child left."""
    from torchft_tpu_torch.train import RECOVERY_TIMEOUT_S, Fault, TrainConfig, run_replicas

    cfg = TrainConfig(config="debug", seq_len=16, steps=6, transport="pg-baby",
                      faults=(Fault(1, 1, "crash", at="backward"),
                              Fault(1, 3, "crash", at="backward"),
                              Fault(0, 3, "kill_recovery_child", chunk=2)))
    fleet = {}
    results = run_replicas(cfg, "cpu", fleet=fleet)
    kills = fleet["recovery_child_kills"]
    assert len(kills) == 1 and kills[0]["replica"] == 0 and kills[0]["leaves_sent"] == 2
    assert set(kills[0]["errored_after_s"]) == {0, 1}
    assert max(kills[0]["errored_after_s"].values()) < RECOVERY_TIMEOUT_S
    r0, r1 = results
    assert r0["step"] == r1["step"] == cfg.steps
    assert r1["restarts"] == 2
    # the init sync, the first crash's heal, and the one after the kill
    assert r1["metrics"]["heals"] == 3
    assert r1["timings"]["heal_attempts"] == 4
    # the crashes' steps and the aborted heal's
    assert r0["metrics"]["commit_failures"] == 3
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert mp.active_children() == []
