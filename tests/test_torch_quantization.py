"""The port's fp8 rowwise codec and quantized allreduce against the JAX
package's, on the CPU.

The JAX kernels run as the JAX package's own tests run them (Pallas in
interpret mode on the CPU). The port's plain torch versions, which its CUDA
kernels are held to on the card by ``chip_smoke.py``, must give the same
codes and scales bit for bit; dequantized values must match bit for bit
except NaN payloads (a NaN matches a NaN of the same sign).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import collectives as jax_coll
from torchft_tpu.coordination import KvStoreServer as JaxKvStoreServer
from torchft_tpu.ops import quantization as jq
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu.process_group import ReduceOp as JaxReduceOp
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.ops import quantization as tq
from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the timing-sensitive tests of parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP8 = np.dtype(ml_dtypes.float8_e4m3fn)


def _input(case: str) -> np.ndarray:
    rng = np.random.RandomState(sum(map(ord, case)))
    if case.startswith("ragged_"):
        return rng.randn(int(case.split("_")[1])).astype(np.float32)
    if case == "zero_rows":
        x = rng.randn(512 * 6).astype(np.float32)
        x[512:1024] = 0.0
        x[2048:2560] = 0.0
        return x
    if case == "mixed_magnitudes":
        n = 512 * 8 + 7
        mag = np.exp(rng.uniform(np.log(1e-8), np.log(1e8), n))
        return (rng.randn(n) * mag).astype(np.float32)
    if case == "non_finite":
        x = rng.randn(512 * 5).astype(np.float32)
        x[3] = np.inf
        x[512 + 9] = -np.inf
        x[1024 + 1] = np.nan
        x[1536 + 2] = -np.float32(np.nan)
        x[1536 + 3] = 1e5  # out of e4m3 range in a scale-1 (NaN) row
        x[1536 + 4] = -1e5
        return x
    if case == "two_d":
        return rng.randn(7, 300).astype(np.float32)
    raise ValueError(case)


CASES = [
    "ragged_1", "ragged_511", "ragged_513", "ragged_1543",
    "zero_rows", "mixed_magnitudes", "non_finite", "two_d",
]


def _same_bits_or_nan(a: np.ndarray, b: np.ndarray) -> None:
    a, b = np.asarray(a, np.float32).reshape(-1), np.asarray(b, np.float32).reshape(-1)
    assert a.shape == b.shape
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b)
    np.testing.assert_array_equal(np.signbit(a[nan_a]), np.signbit(b[nan_b]))
    np.testing.assert_array_equal(a[~nan_a].view(np.uint32), b[~nan_b].view(np.uint32))


@pytest.mark.parametrize("case", CASES)
def test_device_codec_matches_pallas_bitwise(case):
    x = _input(case)
    qj, sj, nj = jq.fused_quantize_fp8(jnp.asarray(x))
    qt, st, nt = tq.quantize_fp8_plain(torch.from_numpy(x))
    assert nt == nj == x.size
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(), np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    # the wrapper on a CPU tensor is the plain version and launches nothing
    tq.reset_launches()
    qw, sw, _ = tq.fused_quantize_fp8(torch.from_numpy(x))
    assert torch.equal(qw.view(torch.uint8), qt.view(torch.uint8))
    assert torch.equal(sw, st)
    dj = jq.fused_dequantize_fp8(qj, sj, nj)
    dt = tq.fused_dequantize_fp8(qt, st, nt)
    assert tq.LAUNCHES == {"quantize_fp8_rowwise": 0, "dequantize_fp8_rowwise": 0,
                           "quantize_fp8_rowwise_host": 0}
    _same_bits_or_nan(dt.numpy(), np.asarray(dj))


def test_subnormal_rows_follow_ieee():
    """XLA's CPU backend flushes subnormals, so the reference kernel turns
    an all-subnormal row into a zero row (scale 1, codes 0); the port, like
    the CUDA kernel built without flush-to-zero, follows IEEE. Its result
    is held to the kernel formula computed in numpy (IEEE, ml_dtypes cast)
    and to the numpy host codec's scales within one ulp (the host codec
    divides amax by 448 where the device path multiplies by 1/448)."""
    x = np.full(1024, 1e-40, np.float32)
    x[::3] = -3e-41
    x[512:] *= 7.0
    qj, sj, _ = jq.fused_quantize_fp8(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(sj), 1.0)  # the flush
    np.testing.assert_array_equal(np.asarray(qj).view(np.uint8) & 0x7F, 0)

    qt, st, _ = tq.quantize_fp8_plain(torch.from_numpy(x))
    mat = x.reshape(2, 512)
    amax = np.max(np.abs(mat), axis=1, keepdims=True)
    scale = (amax * np.float32(1.0 / 448.0)).astype(np.float32)
    codes = (mat / scale).astype(FP8).view(np.uint8)
    np.testing.assert_array_equal(st.numpy(), scale)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(), codes)
    assert (codes & 0x7F).any()  # real codes, not a flushed row

    _, s_host, _ = jq.quantize_fp8_rowwise(x)
    ulps = np.abs(s_host.view(np.int32) - st.numpy().reshape(-1).view(np.int32))
    assert ulps.max() <= 1


def _tiny_rows(ref_scales: np.ndarray) -> np.ndarray:
    """Rows whose reference scale has no finite reciprocal: the reference's
    host rule codes them all NaN (x * inf), the port's as zero rows."""
    with np.errstate(divide="ignore", over="ignore"):
        return np.isinf(np.float32(1.0) / np.asarray(ref_scales).reshape(-1))


def _assert_host_rule(qb, sb, qa, sa):
    """The port's host-rule codes and scales equal the reference's bit for
    bit on every row but those without a finite reciprocal, which are zero
    rows (scale 1, codes +-0) where the reference's are all NaN."""
    qa, qb = np.asarray(qa).reshape(sa.size, -1), np.asarray(qb).reshape(sa.size, -1)
    sb = np.asarray(sb).reshape(-1)
    tiny = _tiny_rows(sa)
    np.testing.assert_array_equal(qb[~tiny], qa[~tiny])
    np.testing.assert_array_equal(sb[~tiny].view(np.uint32), sa[~tiny].view(np.uint32))
    assert (sb[tiny] == 1.0).all() and not (qb[tiny] & 0x7F).any()
    assert ((qa[tiny] & 0x7F) == 0x7F).all()  # the reference's NaN codes
    return tiny


@pytest.mark.parametrize("case", CASES + ["subnormal"])
def test_host_codec_matches_reference_bitwise(case):
    """Bit for bit, but a row whose scale has no finite reciprocal (the
    subnormal case's every row), which the port codes as a zero row."""
    if case == "subnormal":
        x = np.full(700, 2e-40, np.float32)
    else:
        x = _input(case).reshape(-1)
    qa, sa, na = jq.quantize_fp8_rowwise(x)
    qb, sb, nb = tq.quantize_fp8_rowwise(x)
    assert na == nb
    tiny = _assert_host_rule(qb, sb, qa, sa)
    assert tiny.all() if case == "subnormal" else not tiny.any()
    db = tq.dequantize_fp8_rowwise(qb, sb, nb)
    if tiny.any():
        np.testing.assert_array_equal(np.abs(db), 0.0)
    else:
        _same_bits_or_nan(db, jq.dequantize_fp8_rowwise(qa, sa, na))


@pytest.mark.parametrize("case", CASES + ["subnormal", "overflow_row"])
def test_host_rule_plain_version_matches_the_reference_host_codec(case):
    """The plain version of the host-rule quantize kernel (scale = amax /
    448, codes = x * (1 / scale)) gives the reference's host codec's codes
    and scales bit for bit, and the wrapper on a CPU tensor is that plain
    version, launching nothing."""
    if case == "subnormal":
        x = np.full(700, 2e-40, np.float32)
    elif case == "overflow_row":
        x = _input("ragged_1543").reshape(-1)
        x[600] = 3e38
    else:
        x = _input(case).reshape(-1)
    qa, sa, na = jq.quantize_fp8_rowwise(x)
    tq.reset_launches()
    qb, sb, nb = tq.fused_quantize_fp8_host(torch.from_numpy(x))
    assert nb == na and qb.shape == (sa.size, 512) and sb.shape == (sa.size, 1)
    tiny = _assert_host_rule(qb.view(torch.uint8).numpy(), sb.numpy(), qa, sa)
    assert tiny.all() if case == "subnormal" else not tiny.any()
    assert sum(tq.LAUNCHES.values()) == 0


def test_error_feedback_keeps_a_fading_fp8_row_finite():
    """A row that stops receiving gradient: its error-feedback residual
    shrinks by the code's rounding every step until its scale has no
    finite reciprocal. The reference's host codec then codes it all NaN;
    the port's codes a zero row and the residual stays finite and in
    place."""
    rng = np.random.default_rng(0)
    first = (rng.standard_normal(512) * 1e-3).astype(np.float32)
    outs = {}
    for name, mod in (("port", tq), ("ref", jq)):
        res, step_bad = np.zeros(512, np.float32), None
        with np.errstate(all="ignore"):
            for step in range(60):
                v = (first if step == 0 else np.zeros(512, np.float32)) + res
                d = mod.dequantize_fp8_rowwise(*mod.quantize_fp8_rowwise(v))
                if not np.isfinite(d).all():
                    step_bad = step
                    break
                res = v - d
        outs[name] = (step_bad, res)
    assert outs["ref"][0] is not None  # the reference's codec breaks down
    assert outs["port"][0] is None
    assert np.isfinite(outs["port"][1]).all() and 0 < np.abs(outs["port"][1]).max() < 1e-35


def _world_run(world: int, fn):
    with ThreadPoolExecutor(max_workers=world) as ex:
        return list(ex.map(fn, range(world)))


def _pgs(pg_cls, store, world: int, prefix: str):
    pgs = [pg_cls(timeout=30.0) for _ in range(world)]
    addr = f"127.0.0.1:{store.port}/{prefix}"
    _world_run(world, lambda r: pgs[r].configure(addr, r, world, quorum_id=5))
    return pgs


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_allreduce_quantized_matches_reference_bitwise(world, op, engine):
    """Equal inputs through both packages' quantized allreduce over their own
    ProcessGroupHost: the device engine (JAX arrays with the Pallas kernels
    vs torch tensors with the plain versions) and the host engine (numpy in
    both) give bitwise-equal outputs on every rank."""
    rng = np.random.RandomState(world * 10 + len(op))
    inputs = [
        [rng.randn(600).astype(np.float32), (rng.randn(33, 5) * 50).astype(np.float32)]
        for _ in range(world)
    ]
    jstore, tstore = JaxKvStoreServer("127.0.0.1:0"), KvStoreServer("127.0.0.1:0")
    jpgs = _pgs(JaxPGHost, jstore, world, "jax")
    tpgs = _pgs(ProcessGroupHost, tstore, world, "torch")
    try:
        def run_jax(r):
            leaves = [jnp.asarray(a) for a in inputs[r]] if engine == "device" else inputs[r]
            w = jax_coll.allreduce_quantized(leaves, getattr(JaxReduceOp, op.upper()), jpgs[r])
            return [np.asarray(o) for o in w.get_future().wait(30)]

        def run_torch(r):
            leaves = (
                [torch.from_numpy(a) for a in inputs[r]] if engine == "device" else inputs[r]
            )
            w = tcoll.allreduce_quantized(leaves, getattr(ReduceOp, op.upper()), tpgs[r])
            out = w.get_future().wait(30)
            return [o.numpy() if isinstance(o, torch.Tensor) else o for o in out]

        jouts = _world_run(world, run_jax)
        touts = _world_run(world, run_torch)
    finally:
        for pg in jpgs + tpgs:
            pg.shutdown()
        jstore.shutdown()
        tstore.shutdown()
    for r in range(world):
        for a, b in zip(jouts[r], touts[r]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))
    expected = sum(np.asarray(inputs[r][0], np.float64) for r in range(world))
    if op == "avg":
        expected /= world
    np.testing.assert_allclose(touts[0][0], expected, rtol=0.15, atol=np.abs(expected).max() / 4)
