"""The port's DDP helpers and optimizer wrapper against the JAX package's.

First the scenarios of ``tests/test_optim_ddp.py`` on a mock Manager: the
wrapper applies an update only on a committed vote and starts the quorum
in ``zero_grad``; DDP issues one streamed collective per tree; the pure
variant forwards its bucket cap, keeps one bucket per dtype and splits
same-dtype leaves under a small cap, and falls back to one allreduce per
leaf.

Then real Managers of both packages, two replica threads each against an
in-process lighthouse, with the same seeded gradients (numpy in the
reference, CPU tensors in the port): ``ft_allreduce_gradients``, the DDP
wrapper and the pure variant give the reference's averages bit for bit,
raw f32 and fp8 with error feedback, over 3 steps. So does gradient
accumulation: two streamed allreduces of one plan per step share that
plan's error-feedback residuals, and each microbatch reads and writes them
in the reference's order.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from unittest.mock import MagicMock

import numpy as np
import optax
import pytest
import torch

from torchft_tpu import bucketing as jax_bucketing
from torchft_tpu import ddp as jax_ddp
from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.optim import OptimizerWrapper as JaxOptimizerWrapper
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu.work import DummyWork as JaxDummyWork
from torchft_tpu_torch import bucketing, ddp
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.process_group import ProcessGroupHost
from torchft_tpu_torch.work import DummyWork

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


# -- the mock-Manager scenarios ----------------------------------------------

class _EchoStream:
    def __init__(self, v):
        self._v = v

    def wait(self, timeout=None):
        return self._v


def _mock_manager(work_cls, commit=True):
    m = MagicMock()
    m.allreduce.side_effect = lambda v, should_quantize=False: work_cls(v)
    m.allreduce_streamed.side_effect = lambda v, **kw: _EchoStream(v)
    m.should_commit.return_value = commit
    return m


@pytest.mark.parametrize("commit", [True, False])
def test_optimizer_wrapper_applies_only_committed_steps_as_the_reference(commit):
    """SGD lr 0.5 on w = 1 with gradient 0.2: 0.9 when the vote commits,
    1.0 (the step discarded) when it does not, in both packages."""
    jm = _mock_manager(JaxDummyWork, commit)
    jopt = JaxOptimizerWrapper(jm, optax.sgd(0.5))
    params = {"w": np.array([1.0], dtype=np.float32)}
    jstate = jopt.init(params)
    jparams, _, jcommitted = jopt.step(params, jstate, {"w": np.array([0.2], np.float32)})

    tm = _mock_manager(DummyWork, commit)
    w = torch.nn.Parameter(torch.tensor([1.0]))
    topt = OptimizerWrapper(tm, torch.optim.SGD([w], lr=0.5))
    topt.zero_grad()
    tm.start_quorum.assert_called_once()
    w.grad = torch.tensor([0.2])
    assert topt.step() == jcommitted == commit
    np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jparams["w"]))
    np.testing.assert_allclose(w.detach().numpy(), [0.9] if commit else [1.0], rtol=1e-6)


def test_ddp_average_gradients_is_one_streamed_collective():
    m = _mock_manager(DummyWork)
    out = ddp.DistributedDataParallel(m).average_gradients(
        {"a": torch.ones(2), "b": torch.zeros(3)})
    assert m.allreduce_streamed.call_count == 1
    assert m.allreduce.call_count == 0
    torch.testing.assert_close(out["a"], torch.ones(2))


def test_pure_ddp_forwards_its_cap_in_one_streamed_call():
    m = _mock_manager(DummyWork)
    pure = ddp.PureDistributedDataParallel(m)
    out = pure.average_gradients({"a": torch.ones(2), "b": torch.zeros(3)})
    assert m.allreduce_streamed.call_count == 1
    assert m.allreduce_streamed.call_args.kwargs["bucket_cap_bytes"] == pure._bucket_cap_bytes
    assert pure._bucket_cap_bytes == jax_ddp.PureDistributedDataParallel(MagicMock())._bucket_cap_bytes
    torch.testing.assert_close(out["b"], torch.zeros(3))


def test_pure_ddp_buckets_per_dtype_and_cap_as_the_reference():
    """Mixed dtypes keep a bucket each; a 4-byte cap splits same-dtype
    leaves apart: the port's plans have the reference's buckets."""
    grads = {"a": np.ones(2, np.float32), "b": np.zeros(3, np.float64)}
    tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
    m = _mock_manager(DummyWork)
    pure = ddp.PureDistributedDataParallel(m)
    out = pure.average_gradients(tgrads)
    torch.testing.assert_close(out["b"], torch.zeros(3, dtype=torch.float64))
    cap = pure._bucket_cap_bytes
    plan = bucketing.plan_for([tgrads["a"], tgrads["b"]], cap)
    jplan = jax_bucketing.plan_for([grads["a"], grads["b"]], cap)
    assert len(plan) == len(jplan) == 2
    assert plan.groups == jplan.groups and list(plan.sizes) == list(jplan.sizes)

    m2 = _mock_manager(DummyWork)
    pure4 = ddp.PureDistributedDataParallel(m2, bucket_cap_bytes=4)
    g2 = {"a": torch.ones(2), "b": torch.zeros(3)}
    pure4.average_gradients(g2)
    assert m2.allreduce_streamed.call_args.kwargs["bucket_cap_bytes"] == 4
    plan2 = bucketing.plan_for([g2["a"], g2["b"]], 4)
    jplan2 = jax_bucketing.plan_for([np.ones(2, np.float32), np.zeros(3, np.float32)], 4)
    assert len(plan2) == len(jplan2) == 2
    assert plan2.groups == jplan2.groups


@pytest.mark.parametrize("grads", [{"only": torch.ones(4)}, {"a": torch.ones(2), "b": torch.ones(3)}],
                         ids=["one_leaf", "cap_zero"])
def test_pure_ddp_falls_back_to_one_allreduce_per_leaf(grads):
    m = _mock_manager(DummyWork)
    cap = None if len(grads) == 1 else 0
    out = ddp.PureDistributedDataParallel(m, bucket_cap_bytes=cap).average_gradients(grads)
    assert m.allreduce.call_count == len(grads)
    assert m.allreduce_streamed.call_count == 0
    assert sorted(out) == sorted(grads)


def test_ft_allreduce_gradients_streams_with_the_quantize_flag():
    m = _mock_manager(DummyWork)
    g = {"a": torch.ones(2)}
    ddp.ft_allreduce_gradients(m, g, should_quantize=True)
    assert m.allreduce_streamed.call_args.kwargs["should_quantize"] is True


# -- real Managers of both packages ------------------------------------------

def _fleet(package, body, world=2, steps=STEPS, **kwargs):
    """``world`` Managers of ``package`` in threads; ``body(rid, manager,
    step)`` runs between the quorum and the vote. Returns ({rid: [body
    results]}, {rid: [votes]})."""
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
            state_dict=lambda: {}, min_replica_size=world, replica_id=f"d{rid}",
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
            return outs, votes
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
    return {r: d[0] for r, d in enumerate(done)}, {r: d[1] for r, d in enumerate(done)}


def _grads(rid, step, micro=0):
    """The CNN's gradient leaves, seeded, with magnitudes spread over rows
    (the fp8 scales differ per row)."""
    rng = np.random.RandomState(1000 * rid + 10 * step + micro)
    spread = lambda *s: (rng.randn(*s) * np.exp(rng.randn(*s))).astype(np.float32)  # noqa: E731
    return {"w2": spread(64, 10), "conv": spread(3, 3, 3, 16), "w1": spread(4096, 64)}


def _tree(t):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in t.items()}


def _assert_bitwise(tout, jout):
    for r in jout:
        for step, (t, j) in enumerate(zip(tout[r], jout[r])):
            t_list = t if isinstance(t, list) else [t]
            j_list = j if isinstance(j, list) else [j]
            for tt, jj in zip(t_list, j_list):
                tt, jj = _tree(tt), _tree(jj)
                assert sorted(tt) == sorted(jj)
                for k in jj:
                    np.testing.assert_array_equal(tt[k].view(np.int32), jj[k].view(np.int32),
                                                  err_msg=f"rank {r} step {step} leaf {k}")


def _to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


WRAPPERS = {
    "ft_allreduce_gradients": (
        lambda m, q: (lambda g: jax_ddp.ft_allreduce_gradients(m, g, should_quantize=q)),
        lambda m, q: (lambda g: ddp.ft_allreduce_gradients(m, g, should_quantize=q)),
    ),
    "ddp": (
        lambda m, q: jax_ddp.DistributedDataParallel(m, should_quantize=q).average_gradients,
        lambda m, q: ddp.DistributedDataParallel(m, should_quantize=q).average_gradients,
    ),
    "ddp_work": (
        lambda m, q: (lambda g: jax_ddp.DistributedDataParallel(m, should_quantize=q)
                      .allreduce_gradients(g).get_future().wait(TIMEOUT)),
        lambda m, q: (lambda g: ddp.DistributedDataParallel(m, should_quantize=q)
                      .allreduce_gradients(g).get_future().wait(TIMEOUT)),
    ),
    "pure_small_cap": (
        lambda m, q: jax_ddp.PureDistributedDataParallel(
            m, should_quantize=q, bucket_cap_bytes=64 * 1024).average_gradients,
        lambda m, q: ddp.PureDistributedDataParallel(
            m, should_quantize=q, bucket_cap_bytes=64 * 1024).average_gradients,
    ),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("quantize", [False, True], ids=["raw_f32", "fp8_ef"])
def test_ddp_averages_are_the_references_bitwise_over_steps(wrapper, quantize):
    jmake, tmake = WRAPPERS[wrapper]
    jout, jvotes = _fleet("jax", lambda r, m, s: jmake(m, quantize)(_grads(r, s)))
    tout, tvotes = _fleet("torch", lambda r, m, s: tmake(m, quantize)(_to_torch(_grads(r, s))))
    assert tvotes == jvotes == {r: [True] * STEPS for r in range(2)}
    _assert_bitwise(tout, jout)


def test_pure_ddp_per_leaf_path_is_the_references_bitwise():
    """A cap of 0: one managed allreduce per leaf in both packages."""
    jout, _ = _fleet("jax", lambda r, m, s: jax_ddp.PureDistributedDataParallel(
        m, bucket_cap_bytes=0).average_gradients(_grads(r, s)))
    tout, _ = _fleet("torch", lambda r, m, s: ddp.PureDistributedDataParallel(
        m, bucket_cap_bytes=0).average_gradients(_to_torch(_grads(r, s))))
    _assert_bitwise(tout, jout)


@pytest.mark.parametrize("accum", [2, 3])
def test_grad_accum_streams_share_residuals_in_the_references_order(accum):
    """``--grad-accum k --quantize``: k streamed allreduces of one plan per
    step, issued before any is waited on, as the example does. They share
    the plan's error-feedback residuals, so each reduced microbatch (and
    the residuals carried to the next step) is the reference's only if the
    port reads and writes them in the same order."""

    def jbody(rid, manager, step):
        streams = [manager.allreduce_streamed(_grads(rid, step, k), should_quantize=True)
                   for k in range(accum)]
        return [s.wait(timeout=TIMEOUT) for s in streams]

    def tbody(rid, manager, step):
        streams = [manager.allreduce_streamed(_to_torch(_grads(rid, step, k)),
                                              should_quantize=True) for k in range(accum)]
        return [s.wait(timeout=TIMEOUT) for s in streams]

    jout, jvotes = _fleet("jax", jbody)
    tout, tvotes = _fleet("torch", tbody)
    assert tvotes == jvotes
    _assert_bitwise(tout, jout)
