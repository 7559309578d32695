"""The port's DiLoCo against the JAX package's golden fixtures
(``tests/test_fixtures/diloco_*.json``, written by
``tests/test_diloco_regression.py``), at the fixtures' own rtol 1e-6 /
atol 1e-7.

The same script as the reference's regression test: a dict of three small
f32 vectors, a deterministic inner step ``v - 0.1 * grad`` (grad 2
everywhere), 12 inner steps on one replica group against a real
lighthouse and Manager (synchronous quorum) over a
``FakeProcessGroupWrapper``, the outer optimizer ``torch.optim.SGD(lr=0.7,
momentum=0.9, nesterov=True)`` in place of ``optax.sgd(0.7, momentum=0.9,
nesterov=True)``, and the parameters recorded after every inner step. This
file only reads the fixtures.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import FakeProcessGroupWrapper, ProcessGroupHost

FIXTURE_DIR = Path(__file__).parent / "test_fixtures"

STEPS = 12
INNER_LR = 0.1
GRAD = 2.0


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_SYNC_EVERY", "TORCHFT_USE_BUCKETIZATION", "TORCHFT_COMPRESS",
                "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB"):
        monkeypatch.delenv(var, raising=False)


def compare_fixture(name, history):
    golden = json.loads((FIXTURE_DIR / f"{name}.json").read_text())
    assert len(history) == len(golden)
    for step, (got, want) in enumerate(zip(history, golden)):
        assert set(got) == set(want), f"step {step}: key mismatch"
        for key in want:
            np.testing.assert_allclose(
                got[key], want[key], rtol=1e-6, atol=1e-7,
                err_msg=f"step {step} param {key} diverged from fixture",
            )


def inner_step(v, varied_grads):
    if not varied_grads:
        return v - INNER_LR * GRAD
    n = v.shape[0]
    grad = GRAD + 0.05 * (np.arange(n, dtype=np.float32) - n / 2.0)
    return v - torch.from_numpy(INNER_LR * grad)


def run_diloco(lighthouse, *, num_fragments, fragment_sync_delay=0, fragment_update_alpha=0.0,
               sync_every=4, fail_allreduce_at_step=None, use_bucketization=None,
               bucket_cap_mb=None, should_quantize=False, varied_grads=False):
    params = {
        "w0": torch.arange(4, dtype=torch.float32) / 4.0,
        "w1": torch.ones(3, dtype=torch.float32),
        "w2": torch.tensor([-1.0, 1.0], dtype=torch.float32),
    }
    state = {"params": params}

    def load_state(sd):
        for k, v in sd["params"].items():
            state["params"][k].copy_(v)

    pg = FakeProcessGroupWrapper(ProcessGroupHost(timeout=10.0))
    manager = Manager(
        pg=pg, load_state_dict=load_state,
        state_dict=lambda: {"params": dict(state["params"])},
        min_replica_size=1, use_async_quorum=False, replica_id="diloco_regression",
        lighthouse_addr=f"127.0.0.1:{lighthouse.port}", timeout=10.0,
    )
    try:
        diloco = DiLoCo(
            manager, state["params"],
            lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True),
            sync_every=sync_every, num_fragments=num_fragments,
            fragment_sync_delay=fragment_sync_delay,
            fragment_update_alpha=fragment_update_alpha,
            use_bucketization=use_bucketization, bucket_cap_mb=bucket_cap_mb,
            should_quantize=should_quantize,
        )
        history = []
        for step in range(STEPS):
            state["params"] = {k: inner_step(v, varied_grads) for k, v in state["params"].items()}
            if fail_allreduce_at_step is not None and step == fail_allreduce_at_step:
                pg.report_future_error(RuntimeError("injected allreduce failure"))
            state["params"] = diloco.step(state["params"])
            history.append({k: v.numpy().tolist() for k, v in sorted(state["params"].items())})
        return history
    finally:
        manager.shutdown(wait=False)


@pytest.fixture()
def lighthouse():
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=200,
                          quorum_tick_ms=20, heartbeat_timeout_ms=800)
    yield lh
    lh.shutdown()


@pytest.mark.parametrize("name,kwargs", [
    ("diloco_1frag", dict(num_fragments=1)),
    ("diloco_2frag", dict(num_fragments=2, sync_every=4)),
    ("diloco_3frag", dict(num_fragments=3, sync_every=6)),
    ("diloco_2frag_delay1", dict(num_fragments=2, sync_every=4, fragment_sync_delay=1)),
    ("diloco_1frag_alpha05", dict(num_fragments=1, fragment_update_alpha=0.5)),
    ("diloco_1frag_failstep3", dict(num_fragments=1, sync_every=4, fail_allreduce_at_step=3)),
])
def test_fixture(lighthouse, name, kwargs):
    compare_fixture(name, run_diloco(lighthouse, **kwargs))


@pytest.mark.parametrize("name,kwargs", [
    ("diloco_1frag", dict(num_fragments=1)),
    ("diloco_2frag", dict(num_fragments=2, sync_every=4, bucket_cap_mb=1)),
])
def test_bucketized_matches_unbucketized(lighthouse, name, kwargs):
    """Bucketization packs the wire; the training math stays the
    fixture's."""
    compare_fixture(name, run_diloco(lighthouse, use_bucketization=True, **kwargs))


def test_failure_history_differs_from_healthy(lighthouse):
    healthy = run_diloco(lighthouse, num_fragments=1, sync_every=4)
    failed = run_diloco(lighthouse, num_fragments=1, sync_every=4, fail_allreduce_at_step=3)
    # the failed sync restores the globals instead of taking the outer step
    assert not np.allclose(healthy[3]["w1"], failed[3]["w1"])


def test_parameters_are_written_in_place(lighthouse):
    """``step`` writes the synced values into the tensors it was given and
    returns the same tree."""
    params = {"w": torch.ones(3)}
    manager = Manager(
        pg=ProcessGroupHost(timeout=10.0), load_state_dict=lambda sd: None,
        state_dict=lambda: {}, min_replica_size=1, use_async_quorum=False,
        replica_id="in_place", lighthouse_addr=f"127.0.0.1:{lighthouse.port}", timeout=10.0,
    )
    try:
        diloco = DiLoCo(manager, params, lambda ps: torch.optim.SGD(ps, lr=0.5), sync_every=2)
        ptr = params["w"].data_ptr()
        for _ in range(2):
            with torch.no_grad():
                params["w"].sub_(0.25)
            out = diloco.step(params)
            assert out is params and params["w"].data_ptr() == ptr
        # pseudograd 0.5, global 1 - 0.5 * 0.5
        torch.testing.assert_close(params["w"], torch.full((3,), 0.75))
        assert manager.current_step() == 1
    finally:
        manager.shutdown(wait=False)
