"""The port's ``ParameterServer`` (counterpart of
``torchft_tpu/parameter_server.py``) through the reference's five session
tests (``tests/test_parameter_server.py``), and ``broadcast`` on the
process groups: the host PG's against the reference's for the same
arrays, bit for bit, with the root's ack round-trip, plus the dummy and
wrapper groups."""

from __future__ import annotations

import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu import process_group as ref_pg
from torchft_tpu.coordination import KvStoreServer as RefStore
from torchft_tpu_torch import process_group as port_pg
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.parameter_server import ParameterServer
from torchft_tpu_torch.process_group import ReduceOp
from torchft_tpu_torch.retry import RetryPolicy


class _EchoPS(ParameterServer):
    """Serves a fixed parameter vector, then sums one gradient push."""

    def __init__(self, params: np.ndarray, **kw: object) -> None:
        self.params = params
        self.grads: list = []
        super().__init__(**kw)  # type: ignore[arg-type]

    def forward(self, rank: int, pg) -> None:
        pg.broadcast([self.params.copy()], root=0).get_future().wait()
        (g,) = pg.allreduce([np.zeros_like(self.params)], ReduceOp.SUM).get_future().wait()
        self.grads.append(g)


@pytest.fixture()
def ps():
    server = _EchoPS(np.arange(8.0))
    yield server
    server.shutdown()


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("0.0.0.0", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_session_broadcast_and_push(ps):
    pg = ParameterServer.new_session(ps.address(), timeout=30.0)
    try:
        (got,) = pg.broadcast([np.zeros(8)], root=0).get_future().wait()
        np.testing.assert_array_equal(got, np.arange(8.0))
        push = np.full(8, 2.0)
        (reduced,) = pg.allreduce([push], ReduceOp.SUM).get_future().wait()
        np.testing.assert_array_equal(reduced, push)  # the server sent zeros
    finally:
        pg.shutdown()
    deadline = time.monotonic() + 10
    while not ps.grads and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(ps.grads) == 1
    np.testing.assert_array_equal(ps.grads[0], np.full(8, 2.0))


def test_sessions_are_isolated(ps):
    pg1 = ParameterServer.new_session(ps.address(), timeout=30.0)
    (got,) = pg1.broadcast([np.zeros(8)], root=0).get_future().wait()
    np.testing.assert_array_equal(got, np.arange(8.0))
    pg1.shutdown()  # abandoned mid-protocol; a fresh session still works
    pg2 = ParameterServer.new_session(ps.address(), timeout=30.0)
    try:
        (got2,) = pg2.broadcast([np.zeros(8)], root=0).get_future().wait()
        np.testing.assert_array_equal(got2, np.arange(8.0))
        (r,) = pg2.allreduce([np.ones(8)], ReduceOp.SUM).get_future().wait()
        np.testing.assert_array_equal(r, np.ones(8))
    finally:
        pg2.shutdown()


def test_new_session_retries_until_server_up():
    """A client knocking before the server binds backs off (a refused
    connection is retryable) and succeeds once it is up."""
    port = _free_port()
    result: dict = {}

    def client() -> None:
        pg = ParameterServer.new_session(
            f"http://{socket.gethostname()}:{port}", timeout=30.0,
            retry_policy=RetryPolicy(max_attempts=40, base_s=0.05, max_backoff_s=0.2))
        try:
            (result["got"],) = pg.broadcast([np.zeros(8)], root=0).get_future().wait()
        finally:
            pg.shutdown()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    time.sleep(0.4)  # the client is already retrying against a dead port
    server = _EchoPS(np.arange(8.0), port=port)
    try:
        t.join(timeout=30.0)
        assert not t.is_alive(), "client never completed after the server came up"
        np.testing.assert_array_equal(result["got"], np.arange(8.0))
    finally:
        server.shutdown()


def test_new_session_times_out_against_dead_address():
    port = _free_port()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        ParameterServer.new_session(
            f"http://{socket.gethostname()}:{port}", timeout=1.0,
            retry_policy=RetryPolicy(max_attempts=50, base_s=0.05, max_backoff_s=0.2))
    assert time.monotonic() - t0 < 5.0


def test_hung_session_setup_is_bounded_and_isolated():
    """A client that handshakes and never configures is aborted at the
    server's timeout; the handler thread is freed and a later session
    works."""
    server = _EchoPS(np.arange(8.0), timeout=2.0)
    try:
        with urllib.request.urlopen(
                urllib.request.Request(f"{server.address()}/new_session", method="POST"),
                timeout=5.0) as resp:
            assert resp.read()
        deadline = time.monotonic() + 1.0
        while server.active_sessions() < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert server.active_sessions() >= 1
        deadline = time.monotonic() + 10.0
        while server.active_sessions() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.active_sessions() == 0, "handler thread still held after the watchdog"
        pg = ParameterServer.new_session(server.address(), timeout=30.0)
        try:
            (got,) = pg.broadcast([np.zeros(8)], root=0).get_future().wait()
            np.testing.assert_array_equal(got, np.arange(8.0))
        finally:
            pg.shutdown()
    finally:
        server.shutdown()


# -- broadcast ---------------------------------------------------------------

def _broadcast(pg_mod, store_cls, world: int, root: int, arrays_of):
    """Each rank of a ``world``-rank host PG (threads) broadcasts its own
    arrays from ``root``; returns every rank's result."""
    store = store_cls("127.0.0.1:0")
    pgs = [pg_mod.ProcessGroupHost(timeout=20.0) for _ in range(world)]
    out: list = [None] * world

    def run(r: int) -> None:
        pgs[r].configure(f"127.0.0.1:{store.port}/bcast", r, world, quorum_id=1)
        out[r] = pgs[r].broadcast(arrays_of(r), root=root).get_future().wait(20)

    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert all(o is not None for o in out)
        return out
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()


def _rank_arrays(r: int):
    rng = np.random.RandomState(100 + r)
    return [rng.randn(3, 5).astype(np.float32), np.arange(7, dtype=np.int64) * (r + 1),
            rng.randn(1000).astype(np.float64)]


@pytest.mark.parametrize("world,root", [(2, 0), (3, 2)])
def test_host_broadcast_equals_the_references(world, root):
    got = _broadcast(port_pg, KvStoreServer, world, root, _rank_arrays)
    want = _broadcast(ref_pg, RefStore, world, root, _rank_arrays)
    for r in range(world):
        assert len(got[r]) == len(want[r]) == 3
        for a, b, src in zip(got[r], want[r], _rank_arrays(root)):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
            np.testing.assert_array_equal(b, src)


def test_host_broadcast_stages_tensors_as_the_other_ops():
    """Tensors go to the host as the PG's other collectives stage them: an
    f32 tensor arrives as an ndarray, a bf16 one as a CPU bf16 tensor."""
    bf = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)

    def arrays(r):
        return [torch.full((4,), float(r)), bf * (r + 1)]

    out = _broadcast(port_pg, KvStoreServer, 2, 1, arrays)
    for r in range(2):
        a, b = out[r]
        np.testing.assert_array_equal(np.asarray(a), np.full(4, 1.0, np.float32))
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
        assert torch.equal(b, bf * 2)


def test_broadcast_on_the_dummy_and_wrapper_groups():
    x = [np.arange(3.0)]
    assert port_pg.ProcessGroupDummy().broadcast(x, root=0).get_future().wait() == x
    fake = port_pg.FakeProcessGroupWrapper(port_pg.ProcessGroupDummy())
    fake.report_future_error(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        fake.broadcast(x).get_future().wait()
    swallow = port_pg.ErrorSwallowingProcessGroupWrapper(fake)
    fake.report_future_error(RuntimeError("lost"))
    (got,) = swallow.broadcast(x).get_future().wait()
    np.testing.assert_array_equal(got, x[0])
    assert swallow.error() is not None
