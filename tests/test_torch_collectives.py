"""The port's reduce_scatter_quantized and allreduce_compressed against the
JAX package's, on the CPU, over each package's own ProcessGroupHost.

``reduce_scatter_quantized``: the host engine (numpy in both packages) and
the device engine (JAX arrays through the Pallas kernels in interpret mode,
as ``tests/test_quantization.py`` runs them, against torch CPU tensors
through the plain versions, which ``chip_smoke.py`` holds the CUDA kernels
to) must give every rank the same chunk bit for bit, at worlds 2 and 3,
SUM and AVG, on ragged sizes. ``allreduce_compressed`` rides the
compressed ring in fp8 and int8 (``tests/test_compress_stream.py``'s
scenario), bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu import collectives as jax_coll
from torchft_tpu.coordination import KvStoreServer as JaxKvStoreServer
from torchft_tpu.process_group import ProcessGroupDummy as JaxPGDummy
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu.process_group import ReduceOp as JaxReduceOp
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.process_group import ProcessGroupDummy, ProcessGroupHost, ReduceOp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world_run(world: int, fn):
    with ThreadPoolExecutor(max_workers=world) as ex:
        return list(ex.map(fn, range(world)))


def _pgs(pg_cls, store, world: int, prefix: str):
    pgs = [pg_cls(timeout=30.0) for _ in range(world)]
    addr = f"127.0.0.1:{store.port}/{prefix}"
    _world_run(world, lambda r: pgs[r].configure(addr, r, world, quorum_id=7))
    return pgs


def _both(world: int, run_jax, run_torch):
    """Each package's ``run(rank, pg)`` on a world of its own host PGs."""
    jstore, tstore = JaxKvStoreServer("127.0.0.1:0"), KvStoreServer("127.0.0.1:0")
    jpgs = _pgs(JaxPGHost, jstore, world, "jax")
    tpgs = _pgs(ProcessGroupHost, tstore, world, "torch")
    try:
        jouts = _world_run(world, lambda r: run_jax(r, jpgs[r]))
        touts = _world_run(world, lambda r: run_torch(r, tpgs[r]))
    finally:
        for pg in jpgs + tpgs:
            pg.shutdown()
        jstore.shutdown()
        tstore.shutdown()
    return jouts, touts


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_reduce_scatter_quantized_matches_reference_bitwise(world, op, engine):
    rng = np.random.RandomState(world * 31 + len(op) + len(engine))
    # ragged: the concatenation is no whole number of 512-wide rows
    inputs = [
        [rng.randn(700 + 111 * world).astype(np.float32),
         (rng.randn(9, 13) * 40).astype(np.float32)]
        for _ in range(world)
    ]
    jop, top = getattr(JaxReduceOp, op.upper()), getattr(ReduceOp, op.upper())

    def run_jax(r, pg):
        leaves = [jnp.asarray(a) for a in inputs[r]] if engine == "device" else inputs[r]
        return np.asarray(jax_coll.reduce_scatter_quantized(leaves, jop, pg).get_future().wait(30))

    def run_torch(r, pg):
        leaves = [torch.from_numpy(a) for a in inputs[r]] if engine == "device" else inputs[r]
        out = tcoll.reduce_scatter_quantized(leaves, top, pg).get_future().wait(30)
        if engine == "device":
            assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
            return out.numpy()
        assert isinstance(out, np.ndarray)
        return out

    jouts, touts = _both(world, run_jax, run_torch)
    n = sum(a.size for a in inputs[0])
    chunk = -(-(-(-n // world)) // 512) * 512
    for r in range(world):
        assert touts[r].shape == (chunk,)
        _same_bits(jouts[r], touts[r])
    # the chunks are the reduction, up to fp8's error
    full = sum(np.concatenate([a.reshape(-1) for a in inputs[r]]).astype(np.float64)
               for r in range(world))
    if op == "avg":
        full /= world
    got = np.concatenate(touts)[:n]
    np.testing.assert_allclose(got, full, rtol=0.15, atol=np.abs(full).max() / 8)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_reduce_scatter_quantized_world_one_returns_the_flat_input(engine):
    a, b = np.arange(5, dtype=np.float32), np.ones((2, 3), np.float16)
    ref = jax_coll.reduce_scatter_quantized(
        [jnp.asarray(a), jnp.asarray(b)] if engine == "device" else [a, b],
        JaxReduceOp.SUM, JaxPGDummy()).get_future().wait(10)
    out = tcoll.reduce_scatter_quantized(
        [torch.from_numpy(a), torch.from_numpy(b)] if engine == "device" else [a, b],
        ReduceOp.SUM, ProcessGroupDummy()).get_future().wait(10)
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    _same_bits(np.asarray(ref), out)


@pytest.mark.parametrize("mode", ["fp8", "int8"])
def test_allreduce_compressed_matches_reference_bitwise(mode):
    """``tests/test_compress_stream.py``'s API scenario (world 2, AVG, a
    600- and a 40-element leaf) in both packages, both codecs."""
    world = 2
    rng = np.random.RandomState(21)
    lists = [[rng.randn(600).astype(np.float32), rng.randn(40).astype(np.float32)]
             for _ in range(world)]

    def run_jax(r, pg):
        out = jax_coll.allreduce_compressed(lists[r], JaxReduceOp.AVG, pg, mode=mode)
        return [np.asarray(o) for o in out.get_future().wait(30)]

    def run_torch(r, pg):
        return tcoll.allreduce_compressed(lists[r], ReduceOp.AVG, pg, mode=mode) \
            .get_future().wait(30)

    jouts, touts = _both(world, run_jax, run_torch)
    for r in range(world):
        for a, b in zip(jouts[r], touts[r]):
            _same_bits(a, b)
    for i in range(2):
        np.testing.assert_array_equal(touts[0][i], touts[1][i])
        expected = (lists[0][i] + lists[1][i]) / 2
        np.testing.assert_allclose(touts[0][i], expected, rtol=0.2,
                                   atol=np.abs(expected).max() / 8)


class _DeviceNativePG(ProcessGroupDummy):
    device_native = True

    def size(self) -> int:
        return 2


@pytest.mark.parametrize("fn", ["reduce_scatter_quantized", "allreduce_quantized"])
def test_device_native_process_group_is_refused(fn):
    """A device-native group takes torch tensors (the packed device wire,
    tests/test_torch_process_group_device.py); the host engine's numpy wire
    over it is refused."""
    with pytest.raises(TypeError, match="device-native"):
        getattr(tcoll, fn)([np.ones(8, np.float32)], ReduceOp.SUM, _DeviceNativePG())


@pytest.mark.parametrize("fn", ["reduce_scatter_quantized", "allreduce_compressed"])
def test_unsupported_op_raises(fn):
    with pytest.raises(ValueError, match="SUM/AVG"):
        getattr(tcoll, fn)([np.ones(4, np.float32)], ReduceOp.MAX, ProcessGroupDummy())
