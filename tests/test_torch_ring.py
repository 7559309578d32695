"""The port's host wire against the JAX package's: the raw-frame ring, the
compressed self-healing ring and its re-route around a dead link.

Each case runs ``world`` ranks as threads over each package's
``ProcessGroupHost`` with the same seeded inputs (bf16 as ml_dtypes arrays
in the reference, torch bf16 tensors in the port) and holds the port's
results to the reference's bit for bit.
"""

import itertools
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import torchft_tpu.ops.quantization as jq
import torchft_tpu.process_group as jpg
from torchft_tpu.coordination import KvStoreServer as JaxKvStore
from torchft_tpu_torch import process_group as tpg
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.ops import quantization as tq

TIMEOUT = 30.0


def _run(package, world, fn, timeout=TIMEOUT):
    """``fn(rank, pg)`` on each of ``world`` ranks of one mesh; returns the
    results in rank order."""
    kv_cls, pg_cls = {"jax": (JaxKvStore, jpg.ProcessGroupHost),
                      "torch": (KvStoreServer, tpg.ProcessGroupHost)}[package]
    store = kv_cls("127.0.0.1:0")
    out, errors = [None] * world, []

    def rank(r):
        pg = pg_cls(timeout=timeout)
        try:
            pg.configure(f"127.0.0.1:{store.port}/ring", r, world)
            out[r] = fn(r, pg)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            pg.shutdown()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    store.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else _bits(x.numpy())
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize])


def _inputs(world, n, dtype):
    rng = np.random.RandomState(n + world)
    xs = [(rng.randn(n) * np.exp(rng.randn(n))).astype(np.float32) for _ in range(world)]
    if dtype == "bfloat16":
        return [x.astype(ml_dtypes.bfloat16) for x in xs], [torch.from_numpy(x).bfloat16() for x in xs]
    return xs, [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX"])
def test_ring_allreduce_matches_reference_bitwise(world, dtype, op):
    """Payloads above the ring threshold (a ragged length, two leaves of
    one dtype): the port's raw-frame ring sums in the input dtype (bf16
    rounded at each add) in the reference's order."""
    jx, tx = _inputs(world, 50001, dtype)
    jy, ty = _inputs(world, 17, dtype)
    jres = _run("jax", world, lambda r, pg: pg.allreduce(
        [jx[r], jy[r]], getattr(jpg.ReduceOp, op)).get_future().wait(TIMEOUT))
    tres = _run("torch", world, lambda r, pg: pg.allreduce(
        [tx[r], ty[r]], getattr(tpg.ReduceOp, op)).get_future().wait(TIMEOUT))
    for r in range(world):
        for t, j in zip(tres[r], jres[r]):
            np.testing.assert_array_equal(_bits(t), _bits(j))


def test_ring_moves_world_independent_bytes_and_small_payloads_take_the_exchange():
    """Per rank the ring sends 2*(world-1)/world of the payload in raw
    frames (plus headers); a payload under the threshold goes through the
    pickled exchange. wire_stats counts both."""
    world, n = 3, 60000
    _jx, tx = _inputs(world, n, "float32")

    def run(r, pg):
        pg.allreduce([tx[r]], tpg.ReduceOp.SUM).get_future().wait(TIMEOUT)
        big = pg.wire_stats()
        pg.allreduce([tx[r][:100]], tpg.ReduceOp.SUM).get_future().wait(TIMEOUT)
        return big, pg.wire_stats()

    for big, after in _run("torch", world, run):
        seg = -(-n // world) * 4
        assert big["bytes_sent"] == 2 * (world - 1) * (seg + tpg._HDR.size)
        assert big["busy_s"] > 0
        assert after["bytes_sent"] > big["bytes_sent"]


def _wires(world, n, seed):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(n) * np.exp(rng.randn(n))).astype(np.float32) for _ in range(world)]
    xs[0][:512] = 0.0  # an all-zero row
    return ([jq.compress_bucket(x, "fp8") for x in xs],
            [tq.compress_bucket(torch.from_numpy(x), "fp8") for x in xs])


def _assert_wires_equal(t, j):
    np.testing.assert_array_equal(t.payload, j.payload)
    np.testing.assert_array_equal(t.scales.view(np.int32), j.scales.view(np.int32))
    assert (t.n, t.dtype, t.row, t.mode) == (j.n, j.dtype, j.row, j.mode)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("op", ["SUM", "AVG"])
def test_compressed_ring_matches_reference_bitwise(world, op):
    """A CompressedWire rides the compressed ring: each hop decodes, adds
    in f32 (own first), recodes; the allgather circulates the codes. Same
    codes and scales as the reference's, rows not a multiple of world."""
    jw, tw = _wires(world, 512 * 7 + 100, 5)
    jres = _run("jax", world, lambda r, pg: pg.allreduce(
        [jw[r]], getattr(jpg.ReduceOp, op)).get_future().wait(TIMEOUT))
    tres = _run("torch", world, lambda r, pg: pg.allreduce(
        [tw[r]], getattr(tpg.ReduceOp, op)).get_future().wait(TIMEOUT))
    for r in range(world):
        _assert_wires_equal(tres[r][0], jres[r][0])
        np.testing.assert_array_equal(tq.decompress_bucket(tres[r][0]).numpy(),
                                      jq.decompress_bucket(jres[r][0]))


@pytest.mark.parametrize("world,link,at_hop", [(3, (0, 1), 1), (3, (1, 2), 0), (4, (0, 1), 1)])
def test_compressed_ring_reroutes_around_a_dead_link_as_the_reference(world, link, at_hop):
    """A link severed mid-collective at both ends: the port's ring floods
    the re-route, re-forms (an open chain at world 3, a ring avoiding the
    link at world 4), reports the link to the observer, and gives the bits
    of the reference's ring over that order. The reference's answer is
    taken with the dead link known from the start: its own mid-collective
    re-route races (a re-route signal can land between a hop's header and
    its bodies, which then desyncs the receiver; the port sends a hop's
    frames under one lock). A second collective starts from the dead set."""
    jw, tw = _wires(world, 512 * 9 + 3, 11)

    def jfn(r, pg):
        pg._gen.comm.cring_dead.add(frozenset(link))
        return [pg.allreduce([jw[r]], jpg.ReduceOp.AVG).get_future().wait(TIMEOUT)[0]
                for _ in range(2)]

    def tfn(r, pg):
        seen = []
        pg.set_reroute_observer(lambda pair, attempt: seen.append(tuple(pair)))
        if r in link:
            pg.inject_link_fault(*link, at_hop=at_hop)
        out = [pg.allreduce([tw[r]], tpg.ReduceOp.AVG).get_future().wait(TIMEOUT)[0]
               for _ in range(2)]
        return out, seen, set(pg._gen.comm.cring_dead)

    jres = _run("jax", world, jfn)
    tres = _run("torch", world, tfn)
    for r in range(world):
        for t, j in zip(tres[r][0], jres[r]):
            _assert_wires_equal(t, j)
        assert tres[r][2] == {frozenset(link)}
    seen = [p for _, s, _ in tres for p in s]
    assert seen and set(seen) == {tuple(sorted(link))}


def test_ring_and_chain_orders_equal_the_reference():
    """The re-formed ring and the fallback chain are the reference's for
    every set of at most two dead links at worlds 3 to 5."""
    for world in (3, 4, 5):
        links = [frozenset(p) for p in itertools.combinations(range(world), 2)]
        for k in (0, 1, 2):
            for dead in itertools.combinations(links, k):
                dead = set(dead)
                assert tpg._ring_order(world, dead) == jpg._ring_order(world, dead)
                assert tpg._chain_order(world, dead) == jpg._chain_order(world, dead)


def test_world_one_returns_independent_copies():
    _jw, tw = _wires(1, 1000, 3)
    x = torch.randn(50000).bfloat16()

    def fn(r, pg):
        (wire,), (y,) = (pg.allreduce([tw[0]]).get_future().wait(TIMEOUT),
                         pg.allreduce([x]).get_future().wait(TIMEOUT))
        return wire, y

    ((wire, y),) = _run("torch", 1, fn)
    _assert_wires_equal(wire, tw[0])
    assert wire.payload is not tw[0].payload and torch.equal(y, x)
    assert y.data_ptr() != x.data_ptr()


def test_shutdown_stops_the_dispatch_thread():
    """``shutdown()`` returns once the generation's dispatch thread has
    stopped, here after the op it was running: no thread of the group is
    left holding it (or its reroute observer, a Manager and through it a
    model), so a trainer restarting a crashed replica frees the old one."""
    import time

    store = KvStoreServer("127.0.0.1:0")
    pg = tpg.ProcessGroupHost(timeout=TIMEOUT)
    try:
        pg.configure(f"127.0.0.1:{store.port}/solo", 0, 1)
        running = []
        started = threading.Event()

        def slow_op(comm):
            running.append(threading.current_thread())
            started.set()
            time.sleep(0.3)

        fut = pg._submit(slow_op).get_future()
        assert started.wait(10)
        pg.shutdown()
        assert not running[0].is_alive()
        assert fut.done()
    finally:
        pg.shutdown()
        store.shutdown()
