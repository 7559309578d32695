"""The port's point-to-point host PG and PGTransport against the JAX
package's, on the CPU.

Point to point: ``send`` / ``recv`` / ``recv_into`` on ``ProcessGroupHost``
(raw frames from 64 KiB, pickled below; ``recv_into`` lands a frame in the
caller's buffer, the identity of the returned entry saying so; a wrong tag
raises; p2p and collective ops do not mix on one generation; symmetric
send/send does not deadlock; a dead peer fails the receive) and on the
Dummy, with the same arrays received as through the reference's PG.

PGTransport: the scenarios of ``tests/test_checkpointing.py::TestPGTransport``
and its streaming tests: send/recv over the host PG, a large mixed state on
raw frames, a single leaf ranged over many chunks bit for bit, a sender
dying mid-stream, a crc32 mismatch discarding the heal. The wire plan
(``plan_wire_ranges``, ``_wire_groups``, each chunk's crc32) is the
reference's for the same leaf sizes and bytes; the in-place receive keeps
every template tensor's ``data_ptr()``; the per-leaf and batched wires of a
PG without raw frames work too.
"""

import logging
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import PGTransport as JaxPGTransport
from torchft_tpu.checkpointing import pg_transport as jax_pt
from torchft_tpu.checkpointing._serialization import TensorMeta as JaxTensorMeta
from torchft_tpu.checkpointing.transport import plan_wire_ranges as jax_plan
from torchft_tpu.coordination import KvStoreServer as JaxKvStore
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu_torch.checkpointing import PGTransport
from torchft_tpu_torch.checkpointing import pg_transport as pt
from torchft_tpu_torch.checkpointing._serialization import (
    TreeSpecPayload,
    flatten_state,
    payload_memoryview,
)
from torchft_tpu_torch.checkpointing.transport import plan_wire_ranges, stream_chunk_bytes
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.process_group import ProcessGroupDummy, ProcessGroupHost, ReduceOp

TIMEOUT = 10.0


def _pair(store_cls, pg_cls, prefix, timeout=TIMEOUT, quorum_id=3):
    store = store_cls("127.0.0.1:0")
    pgs = [pg_cls(timeout=timeout) for _ in range(2)]
    addr = f"127.0.0.1:{store.port}/{prefix}"
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda r: pgs[r].configure(addr, r, 2, quorum_id), range(2)))
    return store, pgs


def _close(store, pgs):
    for pg in pgs:
        pg.shutdown()
    store.shutdown()


@pytest.fixture
def pair():
    store, pgs = _pair(KvStoreServer, ProcessGroupHost, "p2p")
    yield pgs
    _close(store, pgs)


def _transfer(sender, receiver, state, step=4, timeout=TIMEOUT):
    with ThreadPoolExecutor(2) as ex:
        fs = ex.submit(sender.send_checkpoint, [1], step, state, timeout)
        fr = ex.submit(receiver.recv_checkpoint, 0, sender.metadata(), step, timeout)
        fs.result(timeout=60)
        return fr.result(timeout=60)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(40_000).astype(np.float32), np.arange(7, dtype=np.int64),
            rng.randn(3, 5).astype(np.float64)]


# -- point to point -----------------------------------------------------------

@pytest.mark.parametrize("sizes", [(40_000, 7, 15), (3, 4), (20_000,)],
                         ids=["raw_frames", "pickled", "one_raw"])
def test_p2p_send_recv_equals_the_reference(pair, sizes):
    """The same arrays through both packages' host PGs arrive equal."""
    rng = np.random.RandomState(sum(sizes))
    arrays = [rng.randn(n).astype(np.float32) for n in sizes]
    pair[0].send([torch.from_numpy(a) for a in arrays], 1, tag=7).wait(TIMEOUT)
    got = pair[1].recv(0, tag=7).get_future().wait(TIMEOUT)

    jstore, jpgs = _pair(JaxKvStore, JaxPGHost, "jp2p")
    try:
        jpgs[0].send(arrays, 1, tag=7).wait(TIMEOUT)
        jgot = jpgs[1].recv(0, tag=7).get_future().wait(TIMEOUT)
    finally:
        _close(jstore, jpgs)
    assert len(got) == len(jgot) == len(arrays)
    for g, j, a in zip(got, jgot, arrays):
        np.testing.assert_array_equal(np.asarray(g), a)
        np.testing.assert_array_equal(np.asarray(g), j)


def test_p2p_recv_into_lands_in_the_callers_buffers(pair):
    a = np.arange(50_000, dtype=np.float32)
    b = torch.arange(9, dtype=torch.bfloat16)
    into_a = np.zeros_like(a)
    wrong = np.zeros(3, np.float32)  # a mismatched buffer gets a fresh array
    pair[0].send([a, b], 1, tag=2).wait(TIMEOUT)
    got = pair[1].recv_into([into_a, wrong], 0, tag=2).get_future().wait(TIMEOUT)
    assert got[0] is into_a
    np.testing.assert_array_equal(into_a, a)
    assert got[1] is not wrong and torch.equal(got[1], b)
    assert not wrong.any()


def test_p2p_recv_into_a_torch_tensor_keeps_its_storage(pair):
    src = torch.randn(300, 100)
    dst = torch.zeros(300, 100)
    ptr = dst.data_ptr()
    pair[0].send([src], 1).wait(TIMEOUT)
    got = pair[1].recv_into([dst], 0).get_future().wait(TIMEOUT)
    assert got[0] is dst and dst.data_ptr() == ptr and torch.equal(dst, src)


def test_p2p_wrong_tag_raises(pair):
    pair[0].send([np.ones(3)], 1, tag=1).wait(TIMEOUT)
    with pytest.raises(RuntimeError, match="tag"):
        pair[1].recv(0, tag=2).get_future().wait(TIMEOUT)


def test_p2p_and_collectives_do_not_mix_on_one_generation(pair):
    pair[0].send([np.ones(3)], 1).wait(TIMEOUT)
    with pytest.raises(RuntimeError, match="cannot mix"):
        pair[0].allreduce([np.ones(3)], ReduceOp.SUM)
    # a fresh generation takes either kind again
    store, pgs = _pair(KvStoreServer, ProcessGroupHost, "coll")
    try:
        works = [pg.allreduce([np.ones(3)], ReduceOp.SUM) for pg in pgs]
        for w in works:
            np.testing.assert_array_equal(w.get_future().wait(TIMEOUT)[0], 2.0)
        with pytest.raises(RuntimeError, match="cannot mix"):
            pgs[0].send([np.ones(3)], 1)
    finally:
        _close(store, pgs)


def test_p2p_symmetric_sends_do_not_deadlock(pair):
    """Both ranks send 8 MiB to each other before either receives: the
    writes ride per-peer writer threads, so the receives drain them."""
    big = [np.full(2 << 20, r, np.float32) for r in range(2)]
    sends = [pair[r].send([big[r]], 1 - r) for r in range(2)]
    got = [pair[r].recv(1 - r).get_future().wait(30) for r in range(2)]
    for w in sends:
        w.wait(30)
    for r in range(2):
        np.testing.assert_array_equal(got[r][0], big[1 - r])


def test_p2p_recv_from_a_dead_peer_fails_fast():
    """The peer's process group shuts down (its sockets close) while a
    receive waits: the receive fails well inside its timeout and leaves no
    dispatch thread blocked."""
    store, pgs = _pair(KvStoreServer, ProcessGroupHost, "dead", timeout=30.0)
    try:
        work = pgs[1].recv_into([np.zeros(100_000, np.float32)], 0)
        time.sleep(0.2)
        t0 = time.monotonic()
        pgs[0].shutdown()
        with pytest.raises(Exception):
            work.get_future().wait(20)
        assert time.monotonic() - t0 < 10
        assert pgs[1].errored() is not None
        dispatch = [t for t in threading.enumerate() if t.name == "pg_host_dispatch_r1"]
        pgs[1].shutdown()
        deadline = time.monotonic() + 10
        while any(t.is_alive() for t in dispatch) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(t.is_alive() for t in dispatch)
    finally:
        _close(store, pgs)


def test_dummy_p2p_returns_none():
    pg = ProcessGroupDummy()
    assert pg.send([np.ones(2)], 0).get_future().wait(1) is None
    assert pg.recv(0).get_future().wait(1) is None
    assert pg.recv_into([np.ones(2)], 0).get_future().wait(1) is None
    assert not pg.streams_raw_frames and ProcessGroupHost.streams_raw_frames


# -- the wire plan ---------------------------------------------------------------

LEAF_SIZES = [[100], [10, 0, 25], [0], [], [70_000, 3, 64 * 1024, 1 << 20, 5],
              [1 << 20] * 3 + [17]]


@pytest.mark.parametrize("sizes", LEAF_SIZES, ids=lambda s: f"{len(s)}leaves")
@pytest.mark.parametrize("chunk", [16, 30, 64 * 1024, 32 << 20])
def test_plan_wire_ranges_is_the_references(sizes, chunk):
    assert plan_wire_ranges(sizes, chunk) == jax_plan(sizes, chunk)


@pytest.mark.parametrize("sizes", LEAF_SIZES + [[200 << 20, 100 << 20, 1, 300 << 20]],
                         ids=lambda s: f"{len(s)}leaves")
def test_wire_groups_are_the_references(sizes):
    spec = TreeSpecPayload(b"", [pt.TensorMeta("uint8", (n,), n) for n in sizes])
    jspec = type("Spec", (), {"leaves": [JaxTensorMeta("uint8", (n,), n) for n in sizes]})
    assert PGTransport._wire_groups(spec) == JaxPGTransport._wire_groups(jspec)
    assert PGTransport.BATCH_GROUP_BYTES == JaxPGTransport.BATCH_GROUP_BYTES
    assert PGTransport.SEND_WINDOW == JaxPGTransport.SEND_WINDOW


@pytest.mark.parametrize("sizes", LEAF_SIZES, ids=lambda s: f"{len(s)}leaves")
@pytest.mark.parametrize("num_chunks", [1, 3, 8])
def test_split_chunks_is_the_references(sizes, num_chunks):
    from torchft_tpu.checkpointing._serialization import split_chunks as jax_split
    from torchft_tpu_torch.checkpointing._serialization import split_chunks

    assert split_chunks(sizes, num_chunks) == jax_split(sizes, num_chunks)


def test_stream_chunk_bytes_reads_the_knob_as_the_reference(monkeypatch):
    from torchft_tpu.checkpointing.transport import stream_chunk_bytes as jax_chunk_bytes

    for raw in (None, "65536", "0", "-3", "junk"):
        if raw is None:
            monkeypatch.delenv("TORCHFT_STREAM_CHUNK_BYTES", raising=False)
        else:
            monkeypatch.setenv("TORCHFT_STREAM_CHUNK_BYTES", raw)
        assert stream_chunk_bytes() == jax_chunk_bytes()


def test_metas_payload_bytes_and_chunk_crcs_are_the_references():
    """The same arrays flattened by both packages: equal metas and payload
    bytes, so each planned chunk's crc32 is the reference's."""
    arrays = _arrays(1)
    spec, payloads = flatten_state({"a": [torch.from_numpy(x) for x in arrays]})
    from torchft_tpu.checkpointing._serialization import flatten_state as jax_flatten

    jspec, jpayloads = jax_flatten({"a": arrays})
    assert [(m.dtype, m.shape, m.nbytes, m.kind) for m in spec.leaves] == [
        (m.dtype, m.shape, m.nbytes, m.kind) for m in jspec.leaves]
    wires = [pt._flat_bytes(p) for p in payloads]
    jwires = [np.frombuffer(payload_memoryview(p), np.uint8) for p in jpayloads]
    ranges = plan_wire_ranges([m.nbytes for m in spec.leaves], 4096)
    assert [pt._chunk_crc(wires, c) for c in ranges] == [jax_pt._chunk_crc(jwires, c)
                                                         for c in ranges]


# -- PGTransport --------------------------------------------------------------

def _state():
    return {
        "model": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  "b": torch.ones(4, dtype=torch.bfloat16)},
        "step": 7,
        "opt": [torch.full((2, 2), 3.0, dtype=torch.float64), {"lr": 0.1, "eps": None}],
    }


def _assert_state_equal(a, b):
    import torch.utils._pytree as pytree

    la, ta = pytree.tree_flatten(a)
    lb, tb = pytree.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_send_recv_over_host_pg(pair):
    state = _state()
    out = _transfer(PGTransport(pair[0], timeout=TIMEOUT), PGTransport(pair[1], timeout=TIMEOUT),
                    state)
    _assert_state_equal(state, out)


def test_large_mixed_state_rides_raw_frames(pair):
    rng = np.random.default_rng(5)
    state = {"w_f32": torch.from_numpy(rng.standard_normal(40_000).astype(np.float32)),
             "w_bf16": torch.from_numpy(rng.standard_normal(50_000).astype(np.float32)).bfloat16(),
             "tiny": torch.arange(3.0, dtype=torch.float64), "meta": {"lr": 0.25, "name": "big"}}
    out = _transfer(PGTransport(pair[0], timeout=20), PGTransport(pair[1], timeout=20), state, 5)
    _assert_state_equal(state, out)
    assert out["w_bf16"].dtype == torch.bfloat16
    # the raw frames carry the bytes once: no pickled copies of the leaves
    sent = pair[0]._gen.comm.bytes_sent
    payload = 40_000 * 4 + 50_000 * 2
    assert sent < payload * 1.5, (sent, payload)


def test_ranged_single_leaf_many_chunks_bitwise(pair, monkeypatch):
    monkeypatch.setenv("TORCHFT_STREAM_CHUNK_BYTES", str(64 * 1024))
    state = {"params": {"w": torch.arange(262_144, dtype=torch.float32)}}
    receiver = PGTransport(pair[1], timeout=TIMEOUT)
    out = _transfer(PGTransport(pair[0], timeout=TIMEOUT), receiver, state, 6)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    stats = receiver.last_recv_timings()
    assert stats.num_chunks == 16 and stats.total_bytes == 262_144 * 4 and stats.mb_per_s > 0


def _half_send(pg, state, step):
    """The real wire's header and first chunk, and nothing more."""
    spec, payloads = flatten_state(state)
    wire = payload_memoryview(payloads[0])
    ranges = plan_wire_ranges([len(wire)], 64 * 1024)
    header = pickle.dumps((step, spec, "ranged", ranges))
    pg.send([np.frombuffer(header, np.uint8)], 1, tag=1).wait(5)
    _j, off, ln = ranges[0][0]
    pg.send([np.frombuffer(wire[off:off + ln], np.uint8)], 1, tag=2).wait(5)


@pytest.mark.parametrize("template", [False, True], ids=["wire_buffers", "in_place"])
def test_mid_stream_sender_death_aborts(template):
    """The sender stops after the first chunk: the receive raises within
    its timeout, never hangs or returns torn state (an in-place template is
    left torn, which the Manager's heal protocol tolerates)."""
    store, pgs = _pair(KvStoreServer, ProcessGroupHost, "deadckpt", timeout=3.0)
    try:
        state = {"w": torch.arange(262_144, dtype=torch.float32)}
        tmpl = {"w": torch.zeros(262_144)}
        receiver = PGTransport(pgs[1], timeout=3.0,
                               state_dict_template=(lambda: tmpl) if template else None)
        with ThreadPoolExecutor(2) as ex:
            fs = ex.submit(_half_send, pgs[0], state, 6)
            fr = ex.submit(receiver.recv_checkpoint, 0, "<pg_transport>", 6, 3.0)
            fs.result(timeout=10)
            t0 = time.monotonic()
            with pytest.raises(Exception):
                fr.result(timeout=30)
            assert time.monotonic() - t0 < 15
    finally:
        _close(store, pgs)


def test_crc_mismatch_discards_the_heal(monkeypatch):
    """A header crc that disagrees with the bytes fails the receive (a
    host template leaf takes the frames in its memory before the check, as
    the reference's does: the failed heal is never committed)."""
    monkeypatch.setenv("TORCHFT_STREAM_CHUNK_BYTES", str(64 * 1024))
    real = pt._chunk_crc
    monkeypatch.setattr(pt, "_chunk_crc", lambda wires, chunk: real(wires, chunk) ^ 1)
    store, pgs = _pair(KvStoreServer, ProcessGroupHost, "crc", timeout=5.0)
    try:
        state = {"w": torch.arange(262_144, dtype=torch.float32)}
        tmpl = {"w": torch.zeros(262_144)}
        receiver = PGTransport(pgs[1], timeout=5.0, state_dict_template=lambda: tmpl)
        with ThreadPoolExecutor(2) as ex:
            fs = ex.submit(PGTransport(pgs[0], timeout=5.0).send_checkpoint, [1], 8, state, 5.0)
            fr = ex.submit(receiver.recv_checkpoint, 0, "<pg_transport>", 8, 5.0)
            with pytest.raises(RuntimeError, match="crc"):
                fr.result(timeout=30)
            try:
                fs.result(timeout=30)
            except Exception:
                pass  # the sender may see the aborted stream
    finally:
        _close(store, pgs)


def test_in_place_receive_keeps_every_template_tensors_storage(pair, monkeypatch):
    monkeypatch.setenv("TORCHFT_STREAM_CHUNK_BYTES", str(64 * 1024))
    state = _state()
    state["model"]["big"] = torch.randn(500, 300)
    tmpl = {"model": {k: torch.zeros_like(v) for k, v in state["model"].items()},
            "step": 0, "opt": [torch.zeros(2, 2, dtype=torch.float64), {"lr": 0.0, "eps": None}]}
    ptrs = {k: v.data_ptr() for k, v in tmpl["model"].items()}
    out = _transfer(PGTransport(pair[0], timeout=TIMEOUT),
                    PGTransport(pair[1], timeout=TIMEOUT, state_dict_template=lambda: tmpl), state)
    _assert_state_equal(state, out)
    for k, ptr in ptrs.items():
        assert out["model"][k] is tmpl["model"][k] and tmpl["model"][k].data_ptr() == ptr
    assert out["opt"][0] is tmpl["opt"][0]


@pytest.mark.parametrize("transposed", [False, True], ids=["streamed_in", "copied_in"])
def test_in_place_receive_into_a_live_parameter_keeps_autograd_usable(pair, transposed):
    """A heal writes a parameter an in-flight backward saved: the backward
    still runs (its gradients are discarded: the healing replica sits the
    step out) and the parameter holds the healed values. A contiguous leaf
    takes the frames in its memory; a transposed view of it is written by
    ``place_leaf_like``'s ``copy_``, which must not bump the parameter's
    autograd version."""
    w = torch.nn.Parameter(torch.zeros(400, 100))
    x = torch.randn(8, 400, requires_grad=True)  # the backward saves w
    loss = (x @ w).square().sum()
    leaf = w.detach().t() if transposed else w.detach()
    state = {"w": torch.randn(tuple(leaf.shape))}
    _transfer(PGTransport(pair[0], timeout=TIMEOUT),
              PGTransport(pair[1], timeout=TIMEOUT, state_dict_template=lambda: {"w": leaf}),
              state)
    loss.backward()
    assert torch.equal(leaf, state["w"])


def test_structure_mismatch_degrades_to_wire_buffers(pair, caplog):
    state = _state()
    tmpl = {"other": torch.zeros(3)}
    with caplog.at_level(logging.WARNING):
        out = _transfer(PGTransport(pair[0], timeout=TIMEOUT),
                        PGTransport(pair[1], timeout=TIMEOUT, state_dict_template=lambda: tmpl),
                        state)
    _assert_state_equal(state, out)
    assert "in-place receive degraded" in caplog.text
    assert not tmpl["other"].any()


def test_template_must_be_callable():
    with pytest.raises(TypeError, match="callable"):
        PGTransport(ProcessGroupDummy(), state_dict_template={"w": torch.zeros(2)})


class _NoRawFrames:
    """A PG without raw frames (its recv_into absorbs nothing)."""

    streams_raw_frames = False

    def __init__(self, pg):
        self._inner = pg

    def __getattr__(self, name):
        if name == "recv_into":
            return lambda buffers, src, tag=0: self._inner.recv(src, tag)
        return getattr(self._inner, name)


@pytest.mark.parametrize("template", [False, True], ids=["wire_buffers", "in_place"])
def test_per_leaf_wire_of_a_pg_without_raw_frames(pair, template):
    state = _state()
    state["model"]["big"] = torch.randn(300, 300)
    tmpl = {"model": {k: torch.zeros_like(v) for k, v in state["model"].items()},
            "step": 0, "opt": [torch.zeros(2, 2, dtype=torch.float64), {"lr": 0.0, "eps": None}]}
    out = _transfer(
        PGTransport(_NoRawFrames(pair[0]), timeout=TIMEOUT),
        PGTransport(_NoRawFrames(pair[1]), timeout=TIMEOUT,
                    state_dict_template=(lambda: tmpl) if template else None), state)
    _assert_state_equal(state, out)
    if template:
        assert torch.equal(tmpl["model"]["big"], state["model"]["big"])


def test_batched_wire_is_received(pair):
    """The reference's batched header ``(step, spec, True)``: one message
    per wire group, received into the template where it can absorb."""
    state = {"a": torch.randn(1000), "b": torch.arange(10), "c": 3}
    tmpl = {"a": torch.zeros(1000), "b": torch.zeros(10, dtype=torch.int64), "c": 0}
    spec, payloads = flatten_state(state)
    wires = [pt._flat_bytes(p) for p in payloads]

    def send():
        pair[0].send([np.frombuffer(pickle.dumps((9, spec, True)), np.uint8)], 1, tag=1).wait(5)
        for group in PGTransport._wire_groups(spec):
            pair[0].send([wires[i] for i in group], 1, tag=2).wait(5)

    with ThreadPoolExecutor(1) as ex:
        fs = ex.submit(send)
        out = PGTransport(pair[1], timeout=TIMEOUT, state_dict_template=lambda: tmpl
                          ).recv_checkpoint(0, "<pg_transport>", 9, TIMEOUT)
        fs.result(10)
    _assert_state_equal(state, out)


def test_step_mismatch_raises(pair):
    with ThreadPoolExecutor(1) as ex:
        fs = ex.submit(PGTransport(pair[0], timeout=TIMEOUT).send_checkpoint, [1], 3, _state(),
                       TIMEOUT)
        with pytest.raises(RuntimeError, match="step"):
            PGTransport(pair[1], timeout=TIMEOUT).recv_checkpoint(0, "<pg_transport>", 4, TIMEOUT)
        try:
            fs.result(10)
        except Exception:
            pass


def test_same_state_through_both_packages_arrives_equal():
    """The reference's and the port's transports carry the same values."""
    arrays = _arrays(2)
    tstore, tpgs = _pair(KvStoreServer, ProcessGroupHost, "tt")
    jstore, jpgs = _pair(JaxKvStore, JaxPGHost, "jj")
    try:
        tout = _transfer(PGTransport(tpgs[0]), PGTransport(tpgs[1]),
                         {"a": [torch.from_numpy(x) for x in arrays], "n": 5})
        jout = _transfer(JaxPGTransport(jpgs[0]), JaxPGTransport(jpgs[1]),
                         {"a": arrays, "n": 5})
    finally:
        _close(tstore, tpgs)
        _close(jstore, jpgs)
    assert tout["n"] == jout["n"] == 5
    for t, j in zip(tout["a"], jout["a"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- the Manager's transport ----------------------------------------------------

def _spy_transport(base):
    class Spy(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.configured = []
            self.shut = []

        def configure(self, store_addr, replica_rank, replica_world_size, quorum_id=0):
            self.configured.append((store_addr, replica_rank, replica_world_size, quorum_id))
            super().configure(store_addr, replica_rank, replica_world_size, quorum_id=quorum_id)

        def shutdown(self, wait=True):
            self.shut.append(wait)
            super().shutdown(wait)

    return Spy


def _managers(package, body, transports):
    """Two Managers of ``package`` with the given checkpoint transports
    (init_sync on: replica 1 heals from replica 0 at the first quorum);
    ``body(rid, manager)`` runs one step between the quorum and the vote."""
    if package == "jax":
        from torchft_tpu.coordination import LighthouseServer as Lh
        from torchft_tpu.manager import Manager as M
        pg_cls = JaxPGHost
    else:
        from torchft_tpu_torch.coordination import LighthouseServer as Lh
        from torchft_tpu_torch.manager import Manager as M
        pg_cls = ProcessGroupHost
    lh = Lh(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000, quorum_tick_ms=20,
            heartbeat_timeout_ms=5000)

    def replica(rid):
        state = {"w": torch.full((300, 300), float(rid))} if package == "torch" else {
            "w": np.full((300, 300), float(rid), np.float32)}
        holder = {}

        def load(sd):
            if package == "torch":
                state["w"].copy_(sd["w"])
            else:
                state["w"] = np.asarray(sd["w"])

        m = M(pg=pg_cls(timeout=TIMEOUT), load_state_dict=load, state_dict=lambda: dict(state),
              min_replica_size=1, replica_id=f"t{rid}", lighthouse_addr=f"127.0.0.1:{lh.port}",
              timeout=TIMEOUT, checkpoint_transport=transports[rid](holder))
        holder["manager"] = m
        try:
            m.start_quorum()
            out = body(rid, m, state)
            committed = m.should_commit()
            return out, committed, m.timings(), m.metrics(), state
        finally:
            m.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(2) as ex:
            return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def test_manager_heals_over_pg_transport_in_place_and_records_the_stream():
    recovery_pgs = []

    def make(holder):
        pg = ProcessGroupHost(timeout=TIMEOUT)
        recovery_pgs.append(pg)
        return _spy_transport(PGTransport)(
            pg, timeout=TIMEOUT, state_dict_template=lambda: holder["manager"].state_dict_template())

    spies = {}

    def transports(rid):
        def build(holder):
            spies[rid] = make(holder)
            return spies[rid]
        return build

    def body(rid, manager, state):
        ptr = state["w"].data_ptr()
        manager.wait_quorum()
        return ptr

    try:
        out = _managers("torch", body, [transports(0), transports(1)])
    finally:
        for pg in recovery_pgs:
            pg.shutdown()
    (ptr0, c0, t0, m0, s0), (ptr1, c1, t1, m1, s1) = out
    assert c0 and c1 and m1["heals"] == 1 and m0["heals"] == 0
    assert torch.equal(s1["w"], torch.zeros(300, 300)) and s1["w"].data_ptr() == ptr1
    assert t1["heal_chunks"] >= 1 and t1["heal_mb_per_s"] > 0 and "heal_send_s" in t0
    for rid in (0, 1):
        (addr, rank, world, qid), = spies[rid].configured
        assert addr.split("/", 1)[1] == f"torchft/{qid}/recovery/0" and world == 2
        assert spies[rid].shut == [False]


def test_manager_configures_the_transport_under_the_references_prefix():
    """Both packages' Managers hand their transports the same store-prefix
    shape (``<store>/torchft/<quorum_id>/recovery/<group_rank>``) and shut
    them down with ``Manager.shutdown``."""
    from torchft_tpu.checkpointing import HTTPTransport as JaxHTTP
    from torchft_tpu_torch.checkpointing import HTTPTransport

    spies = {"jax": {}, "torch": {}}

    def transports(package, cls):
        def per(rid):
            def build(_holder):
                spies[package][rid] = _spy_transport(cls)(timeout=TIMEOUT)
                return spies[package][rid]
            return build
        return [per(0), per(1)]

    body = lambda rid, m, state: None  # noqa: E731
    _managers("jax", body, transports("jax", JaxHTTP))
    tout = _managers("torch", body, transports("torch", HTTPTransport))
    for package in ("jax", "torch"):
        for rid in (0, 1):
            (addr, rank, world, qid), = spies[package][rid].configured
            assert addr.split("/", 1)[1] == f"torchft/{qid}/recovery/0"
            assert world == 2 and spies[package][rid].shut == [False]
    # the HTTP heal reports its chunk stream too
    assert tout[1][2]["heal_chunks"] >= 1 and tout[1][2]["heal_mb_per_s"] > 0
