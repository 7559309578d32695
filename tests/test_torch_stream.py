"""The port's streamed bucket allreduce against the JAX package's, at the
Manager level.

Replica groups run as threads against an in-process lighthouse in each
package, with the same seeded gradients (numpy in the reference, torch CPU
tensors in the port; bf16 as ml_dtypes and torch bf16) and both Managers
left at their defaults: streaming on, a 1 GiB bucket cap, compression off
(``should_quantize=True`` then streams fp8 buckets with error feedback).
``init_sync`` is off so every replica participates in every step.

Held, bitwise: ``allreduce`` with and without ``should_quantize`` over 3
steps (the residuals carried), at world 2 and 3; the same with a small cap
(several buckets per dtype); the reference's link-kill script (a dead ring
link mid-collective at world 3: the compressed ring re-routes to the same
chain); and within the port, streamed uncompressed against the serial
path. A failed bucket gives zeros and a False vote.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu.process_group import ReduceOp as JaxReduceOp
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp
from torchft_tpu_torch.work import FutureWork

TIMEOUT = 30.0
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_COMPRESS", "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB"):
        monkeypatch.delenv(var, raising=False)


def _fleet(package, world, body, steps=STEPS, **kwargs):
    """``world`` Managers of ``package`` ("jax" or "torch") in threads;
    ``body(rid, manager, step)`` runs between the quorum and the vote.
    Returns ({rid: [body results]}, {rid: [votes]}, {rid: timings})."""
    lh_cls, mgr_cls, pg_cls = {
        "jax": (JaxLighthouse, JaxManager, JaxPGHost),
        "torch": (LighthouseServer, Manager, ProcessGroupHost),
    }[package]
    lh = lh_cls(bind="127.0.0.1:0", min_replicas=world, join_timeout_ms=5000,
                quorum_tick_ms=20, heartbeat_timeout_ms=5000)
    barrier = threading.Barrier(world)

    def replica(rid):
        manager = mgr_cls(
            pg=pg_cls(timeout=TIMEOUT), load_state_dict=lambda sd: None,
            state_dict=lambda: {}, min_replica_size=world, replica_id=f"s{rid}",
            lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=TIMEOUT,
            quorum_timeout=TIMEOUT, init_sync=False, **kwargs,
        )
        try:
            outs, votes = [], []
            for step in range(steps):
                barrier.wait(timeout=60)
                manager.start_quorum()
                outs.append(body(rid, manager, step))
                votes.append(manager.should_commit())
            return outs, votes, manager.timings()
        except BaseException:
            barrier.abort()
            raise
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=world) as ex:
            done = [f.result(timeout=180) for f in [ex.submit(replica, r) for r in range(world)]]
    finally:
        lh.shutdown()
    return ({r: d[0] for r, d in enumerate(done)}, {r: d[1] for r, d in enumerate(done)},
            {r: d[2] for r, d in enumerate(done)})


def _grads(rid, step, n=6000):
    """Seeded gradients: f32 and bf16 leaves, keys inserted out of sorted
    order, magnitudes spread over rows (the fp8 scales differ per row)."""
    rng = np.random.RandomState(1000 * rid + step)
    spread = lambda k: (rng.randn(k) * np.exp(rng.randn(k))).astype(np.float32)  # noqa: E731
    return {
        "w_out": spread(3 * n).reshape(3, n),
        "bias": spread(700),
        "emb": spread(2 * n).astype(ml_dtypes.bfloat16),
        "attn": spread(n + 77).astype(ml_dtypes.bfloat16),
    }


def _to_torch(tree):
    return {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
            if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.int16 if x.dtype == torch.int16 else np.int32)
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x.view(np.int32)


def _assert_trees_equal(tout, jout):
    for r in jout:
        for step in range(len(jout[r])):
            assert sorted(tout[r][step]) == sorted(jout[r][step])
            for k in jout[r][step]:
                np.testing.assert_array_equal(_bits(tout[r][step][k]), _bits(jout[r][step][k]),
                                              err_msg=f"rank {r} step {step} leaf {k}")


def _run_both(world, quantize, **kwargs):
    def jbody(rid, manager, step):
        return manager.allreduce(_grads(rid, step), should_quantize=quantize).get_future().wait(TIMEOUT)

    def tbody(rid, manager, step):
        out = manager.allreduce(_to_torch(_grads(rid, step)), should_quantize=quantize)
        return out.get_future().wait(TIMEOUT)

    jout, jvotes, _ = _fleet("jax", world, jbody, **kwargs)
    tout, tvotes, timings = _fleet("torch", world, tbody, **kwargs)
    assert tvotes == jvotes == {r: [True] * STEPS for r in range(world)}
    _assert_trees_equal(tout, jout)
    return tout, timings


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "fp8_ef"])
def test_default_allreduce_bitwise_over_steps(world, quantize):
    """Default Managers in both packages: the streamed allreduce (raw
    buckets through the ring; or fp8 buckets with error feedback through
    the compressed ring) is bitwise the reference's at every step."""
    _tout, timings = _run_both(world, quantize)
    for r in range(world):
        # one bucket per dtype under the 1 GiB cap
        assert timings[r]["allreduce_buckets"] == 2.0
        assert timings[r]["allreduce_wire_s"] > 0


@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "fp8_ef"])
def test_small_cap_streams_many_buckets_bitwise(quantize):
    """A 16 KiB cap cuts each dtype into several buckets (the oversized
    leaves alone), streamed three stages deep: still the reference's bits."""
    _tout, timings = _run_both(2, quantize, bucket_cap_bytes=16 * 1024)
    assert timings[0]["allreduce_buckets"] == 4.0
    assert 0.0 <= timings[0]["overlap_efficiency"] <= 1.0


def test_bf16_is_summed_in_bf16_at_world_3():
    """Regression: the port once staged bf16 leaves as f32 and summed them
    in f32, where the reference sums bf16 in bf16 on its ring. At world 3
    the two differ (each add rounds); the port must give the reference's."""
    world = 3
    data = [np.random.RandomState(r).randn(40000).astype(np.float32) for r in range(world)]

    def jbody(rid, manager, step):
        g = {"x": data[rid].astype(ml_dtypes.bfloat16), "y": data[rid][:100].copy()}
        return manager.allreduce(g, reduce_op=JaxReduceOp.SUM).get_future().wait(TIMEOUT)

    def tbody(rid, manager, step):
        g = {"x": torch.from_numpy(data[rid]).bfloat16(), "y": torch.from_numpy(data[rid][:100].copy())}
        return manager.allreduce(g, reduce_op=ReduceOp.SUM).get_future().wait(TIMEOUT)

    jout, _, _ = _fleet("jax", world, jbody, steps=1)
    tout, _, _ = _fleet("torch", world, tbody, steps=1)
    _assert_trees_equal(tout, jout)
    ref = jout[0][0]["x"]
    f32_sum = sum(d.astype(ml_dtypes.bfloat16).astype(np.float32) for d in data).astype(ml_dtypes.bfloat16)
    assert (f32_sum.view(np.int16) != ref.view(np.int16)).any(), "the data must tell the sums apart"


def test_link_kill_reroutes_as_the_reference():
    """The reference's link-kill script (``tests/test_compress_stream.py``):
    world 3, compressed fp8 stream, 4 KiB-leaf buckets, link 0<->1
    severed from hop 1 of step 1 at both ends. The port commits every
    step, as the script expects, after re-routing to an open chain, and
    gives the reference's bits. The reference runs with the dead link known
    to every rank from step 1 on (the chain from the start): its own
    mid-collective re-route races (a re-route signal can land between a
    hop's header and its bodies; the port sends a hop under one lock)."""
    rng = np.random.RandomState(6)
    base = {f"w{i}": rng.randn(3000).astype(np.float32) for i in range(4)}

    def jbody(rid, manager, step):
        if step == 1:
            manager._pg._gen.comm.cring_dead.add(frozenset((0, 1)))
        contrib = {k: v * (rid + 1) for k, v in base.items()}
        return manager.allreduce_streamed(contrib).wait(timeout=60)

    def tbody(rid, manager, step):
        if step == 1 and rid in (0, 1):
            manager._pg.inject_link_fault(0, 1, at_hop=1)
        contrib = {k: torch.from_numpy(v * (rid + 1)) for k, v in base.items()}
        return manager.allreduce_streamed(contrib).wait(timeout=60)

    kwargs = dict(compress="fp8", bucket_cap_bytes=4000 * 4)
    jout, jvotes, _ = _fleet("jax", 3, jbody, **kwargs)
    tout, tvotes, ttimings = _fleet("torch", 3, tbody, **kwargs)
    assert tvotes == jvotes == {r: [True] * STEPS for r in range(3)}
    _assert_trees_equal(tout, jout)
    assert sum(t.get("collective_reroute", 0.0) for t in ttimings.values()) >= 1
    np.testing.assert_allclose(tout[0][-1]["w0"].numpy(), base["w0"] * 2.0, rtol=0.2, atol=0.3)


def test_streamed_raw_equals_serial_within_the_port():
    """Compression off, the streamed pipeline (small cap: several buckets)
    and the serial path (``stream_buckets=False``) give the same bits, as
    in the reference (``test_off_is_bit_identical_to_serial_path``)."""

    def body(rid, manager, step):
        return manager.allreduce(_to_torch(_grads(rid, step))).get_future().wait(TIMEOUT)

    streamed, _, st = _fleet("torch", 2, body, bucket_cap_bytes=16 * 1024)
    serial, _, se = _fleet("torch", 2, body, stream_buckets=False)
    _assert_trees_equal(streamed, serial)
    assert st[0]["allreduce_buckets"] == 4.0 and "allreduce_buckets" not in se[0]


def test_failed_bucket_gives_zeros_and_a_false_vote():
    """One bucket's collective fails on every replica: the stream resolves
    to zeros, the failed bucket is never ready, and the step is discarded
    (as the reference's swallow contract)."""

    def body(rid, manager, step):
        real = manager._pg.allreduce
        calls = [0]

        def failing(arrays, op):
            calls[0] += 1
            if calls[0] == 2:
                from torchft_tpu_torch.work import Future

                fut = Future()
                fut.set_exception(RuntimeError("injected bucket failure"))
                return FutureWork(fut)
            return real(arrays, op)

        manager._pg.allreduce = failing
        try:
            stream = manager.allreduce_streamed(_to_torch(_grads(rid, step)), bucket_cap_bytes=16 * 1024)
            out = stream.wait(TIMEOUT)
        finally:
            manager._pg.allreduce = real
        return out, [stream.ready(i) for i in range(stream.num_buckets)]

    outs, votes, _ = _fleet("torch", 2, body, steps=1)
    for r in range(2):
        tree, ready = outs[r][0]
        assert votes[r] == [False]
        assert ready[1] is False and len(ready) == 4
        assert all(not bool(v.any()) for v in tree.values())
