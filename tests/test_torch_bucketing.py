"""The port's bucket plans, packing, bucket codec, error feedback and the
small pieces the streamed allreduce stands on, against the JAX package's.

Seeded numpy inputs go to both packages (bf16 as ml_dtypes arrays in the
reference, torch bf16 tensors in the port); plans, codes, scales and
residuals are compared exactly.
"""

import random
import types
from collections import OrderedDict, namedtuple

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torchft_tpu.bucketing as jb
import torchft_tpu.ops.quantization as jq
import torchft_tpu.retry as jr
import torchft_tpu.work as jw
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu_torch import bucketing as tb
from torchft_tpu_torch import retry as tr
from torchft_tpu_torch import work as tw
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.ops import quantization as tq

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
       "int32": np.int32}


def _leaves(specs, seed=0):
    """(reference leaves, port leaves) of [(shape, dtype name), ...]."""
    rng = np.random.RandomState(seed)
    ref, port = [], []
    for shape, dt in specs:
        x = np.asarray(rng.randn(*shape) * 10, dtype=np.float32)
        a = x.astype(_NP[dt])
        ref.append(a)
        port.append(torch.from_numpy(x).bfloat16() if dt == "bfloat16" else torch.from_numpy(a.copy()))
    return ref, port


TREES = {
    "mixed": [((300, 7), "float32"), ((1025,), "bfloat16"), ((64,), "float16"),
              ((10, 10), "float32"), ((5,), "int32"), ((2000,), "bfloat16")],
    "oversized": [((10,), "float32"), ((5000,), "float32"), ((20,), "float32")],
    "scalars": [((), "float32"), ((3,), "float32"), ((), "bfloat16")],
}


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("cap", [0, 4096, 1 << 30])
def test_plans_equal_the_reference(tree, cap):
    ref, port = _leaves(TREES[tree])
    jp, tp = jb.build_plan(ref, cap), tb.build_plan(port, cap)
    assert tp.groups == jp.groups
    assert tp.metas == jp.metas
    assert tp.sizes == jp.sizes
    assert [tq.dtype_name(d) for d in tp.dtypes] == [np.dtype(d).name for d in jp.dtypes]
    # cached: the same plan object per (tree spec, leaf specs, cap)
    leaves, spec = tb.tree_flatten({f"k{i}": l for i, l in enumerate(port)})
    jl, jspec = jax.tree_util.tree_flatten({f"k{i}": l for i, l in enumerate(ref)})
    a = tb.plan_for(leaves, cap, treedef=spec)
    assert tb.plan_for(leaves, cap, treedef=spec) is a
    assert tb.plan_for(leaves, cap + 1, treedef=spec) is not a
    assert a.groups == jb.plan_for(jl, cap, treedef=jspec).groups


def test_tree_flatten_follows_jax_leaf_order():
    """Dict keys sorted (torch's pytree keeps insertion order), an
    OrderedDict in its order, lists, tuples and namedtuples in order."""
    Pair = namedtuple("Pair", ["z", "a"])
    tree = {"w": [3, {"c": 1, "b": 2}], "a": (4, Pair(z=5, a={"y": 6, "x": 7})),
            "m": OrderedDict([("q", 8), ("p", 9)])}
    leaves, spec = tb.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    back = tb.pytree.tree_unflatten(leaves, spec)
    assert back == tree and list(back) == sorted(tree)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_pack_unpack_round_trip_bitwise(tree):
    _ref, port = _leaves(TREES[tree], seed=3)
    plan = tb.build_plan(port, 4096)
    pool = tb.BufferPool()
    # numpy leaves pack into (pooled) CPU buffers, tensors concatenate
    mixed = [l.numpy() if i % 2 and l.dtype != torch.bfloat16 else l for i, l in enumerate(port)]
    for leaves in (port, mixed, mixed):
        flats, pooled = tb.pack(leaves, plan, pool=pool)
        assert [f.numel() for f in flats] == plan.sizes
        assert all(f.dtype == d for f, d in zip(flats, plan.dtypes))
        for orig, back in zip(port, tb.unpack(flats, plan)):
            assert back.shape == orig.shape and torch.equal(back, orig)
        # a private copy: changing the leaves leaves the buckets as they were
        before = [f.clone() for f in flats]
        for l in port:
            l.add_(1)
        assert all(torch.equal(a, b) for a, b in zip(before, flats))
        for l in port:
            l.sub_(1)
        for b in pooled:
            pool.release(b)
    assert pool.hits > 0


def test_buffer_pool_recycles_per_key_up_to_its_limit():
    pool = tb.BufferPool(max_per_key=1)
    a = pool.acquire(10, torch.float32)
    pool.release(a)
    pool.release(torch.empty(10))
    assert pool.acquire(10, torch.float32) is a and (pool.hits, pool.misses) == (1, 1)
    assert pool.acquire(10, torch.bfloat16) is not a


def _codec_input(case, n=512 * 5 + 37):
    rng = np.random.RandomState(17)
    x = (rng.randn(n) * np.exp(rng.randn(n) * 2)).astype(np.float32)
    if case == "zero":
        x[:] = 0.0
    elif case == "overflow":
        x[5] = 3e38
        x[600] = -1e30
    elif case == "non_finite":
        x[3], x[700], x[1500], x[1501] = np.inf, -np.inf, np.nan, 1e5
    return x


@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("case", ["random", "zero", "overflow", "non_finite", "bfloat16"])
def test_bucket_codec_equals_the_reference_bitwise(mode, case):
    x = _codec_input(case)
    if case == "bfloat16":
        jin, tin = x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        jin, tin = x, torch.from_numpy(x.copy())
    jwire, twire = jq.compress_bucket(jin, mode), tq.compress_bucket(tin, mode)
    np.testing.assert_array_equal(twire.payload, jwire.payload)
    np.testing.assert_array_equal(twire.scales.view(np.uint32), jwire.scales.view(np.uint32))
    assert (twire.n, twire.dtype, twire.row, twire.mode) == (jwire.n, jwire.dtype, jwire.row, jwire.mode)
    jout, tout = jq.decompress_bucket(jwire), tq.decompress_bucket(twire)
    tbits = tout.view(torch.int16).numpy() if tout.dtype == torch.bfloat16 else tout.numpy().view(np.int32)
    jbits = jout.view(np.int16) if jout.dtype == ml_dtypes.bfloat16 else jout.view(np.int32)
    nan = np.isnan(np.asarray(jout, np.float32))
    np.testing.assert_array_equal(np.isnan(tout.float().numpy()), nan)
    np.testing.assert_array_equal(tbits[~nan], jbits[~nan])


def test_compress_mode_resolution(monkeypatch):
    monkeypatch.delenv(tq.COMPRESS_ENV, raising=False)
    assert tq.resolve_compress_mode() == "off" and tq.resolve_compress_mode(" FP8 ") == "fp8"
    monkeypatch.setenv(tq.COMPRESS_ENV, "int8")
    assert tq.resolve_compress_mode("fp8") == "int8"
    monkeypatch.setenv(tq.COMPRESS_ENV, "zstd")
    with pytest.raises(ValueError, match="invalid compress mode"):
        tq.resolve_compress_mode()
    assert tq.COMPRESS_MODES == jq.COMPRESS_MODES
    assert tq.is_compressed_wire(tq.compress_bucket(np.ones(3, np.float32), "fp8"))
    with pytest.raises(ValueError):
        tq.codec("zstd")


@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_feedback_residuals_equal_the_reference_over_steps(mode, dtype):
    """``_compress_bucket_ef`` over 3 steps of one bucket: the wire and the
    carried residual are the reference's at every step; a non-participant
    (no residual store) codes its zeros without touching it."""
    jself = types.SimpleNamespace(_buffer_pool=jb.BufferPool())
    tself = types.SimpleNamespace(_buffer_pool=tb.BufferPool())
    jstore, tstore = [None, None], [None, None]
    for step in range(3):
        x = _codec_input("random") * (step + 1)
        jflat = x.astype(_NP[dtype])
        tflat = torch.from_numpy(x).bfloat16() if dtype == "bfloat16" else torch.from_numpy(x.copy())
        jwire = JaxManager._compress_bucket_ef(jself, jflat, mode, jflat.dtype, jstore, 1)
        twire = Manager._compress_bucket_ef(tself, tflat, mode, tflat.dtype, tstore, 1)
        np.testing.assert_array_equal(twire.payload, jwire.payload)
        np.testing.assert_array_equal(twire.scales.view(np.uint32), jwire.scales.view(np.uint32))
        assert twire.dtype == jwire.dtype == dtype
        np.testing.assert_array_equal(tstore[1].numpy().view(np.uint32), jstore[1].view(np.uint32))
        assert tstore[0] is None
    zeros = Manager._compress_bucket_ef(tself, torch.zeros(100), mode, torch.float32, None, 0)
    assert not zeros.payload.any()


def test_join_futures_and_grad_stream_match_the_reference():
    for mod in (jw, tw):
        futs = [mod.Future() for _ in range(3)]
        joined = mod.join_futures(futs)
        stream = mod.GradStream(futs, joined)
        futs[1].set_result("b")
        assert stream.ready(1) and not stream.ready(0) and len(stream) == stream.num_buckets == 3
        futs[0].set_result("a")
        futs[2].set_result("c")
        assert stream.wait(1) == ["a", "b", "c"] and stream.get_future() is joined
        bad = [mod.Future(), mod.Future()]
        joined = mod.join_futures(bad)
        bad[0].set_exception(RuntimeError("x"))
        assert isinstance(joined.exception(), RuntimeError)
        bad[1].set_result(1)
        assert not mod.GradStream(bad, joined).ready(0)
        assert mod.join_futures([]).wait(1) == []


def test_retry_policy_and_call_match_the_reference(monkeypatch):
    monkeypatch.setenv("TORCHFT_RETRY_MAX_ATTEMPTS", "4")
    monkeypatch.setenv("TORCHFT_RETRY_BASE_S", "0.01")
    tp, jp = tr.RetryPolicy.from_env(jitter=0.25), jr.RetryPolicy.from_env(jitter=0.25)
    assert (tp.max_attempts, tp.base_s, tp.max_backoff_s, tp.jitter) == (
        jp.max_attempts, jp.base_s, jp.max_backoff_s, jp.jitter) == (4, 0.01, 1.0, 0.25)
    for attempt in range(1, 7):
        for full in (False, True):
            assert tp.backoff_s(attempt, random.Random(attempt), full) == jp.backoff_s(
                attempt, random.Random(attempt), full)

    def run(mod, fail_times):
        calls, sleeps = [], []

        def fn(budget):
            calls.append(budget)
            if len(calls) <= fail_times:
                raise ConnectionError(len(calls))
            return "ok"

        try:
            out = mod.retry_call(fn, mod.RetryPolicy(max_attempts=3, base_s=0.01), timeout=5.0,
                                 rng=random.Random(0), sleep=sleeps.append)
        except Exception as e:  # noqa: BLE001 - compared below
            out = (type(e).__name__, getattr(e, "attempts", None))
        return out, len(calls), sleeps

    for fail_times in (0, 2, 5):
        assert run(tr, fail_times) == run(jr, fail_times)
    with pytest.raises(ConnectionError):
        tr.retry_call(lambda b: (_ for _ in ()).throw(ConnectionError()),
                      tr.RetryPolicy(max_attempts=1), timeout=1.0)
