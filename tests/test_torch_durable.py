"""The port's durable (tier-2) checkpoints
(``torchft_tpu_torch/checkpointing/durable.py``, on DCP) against the JAX
package's (``torchft_tpu/checkpointing/durable.py``, on orbax).

Every scenario of ``tests/test_durable.py`` runs on the port; one parity
test drives both packages' ``DurableCheckpointer`` through the same calls
on seeded numpy arrays and holds their steps, their restored manager and
data dicts and their restored arrays equal. Then what the port must do
that orbax did for the reference: a save killed mid-write never becomes
the latest step, and two gloo ranks with different local shards under the
same keys each restore their own (this file run as a script is one rank).
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)


def _rank_worker(tmp: str) -> None:
    """One gloo rank: local shards of its own under keys every rank shares,
    saved, zeroed and restored in place."""
    import torch.distributed as dist

    from torchft_tpu_torch.checkpointing import DurableCheckpointer

    payload = torch.load(os.path.join(tmp, "payload.pt"))
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rng = np.random.RandomState(100 + rank)
    state = {"params": {"w": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
                        "b": torch.from_numpy(rng.randn(8).astype(np.float32)).bfloat16()},
             "opt": {"step": torch.tensor(float(rank + 1))}}
    saved = {k: {n: t.clone() for n, t in v.items()} for k, v in state.items()}
    ckpt = DurableCheckpointer(payload["dir"], digest=True)
    assert ckpt.save(5, state)
    ckpt.wait()
    for v in state.values():
        for t in v.values():
            t.zero_()
    restored, _, _ = ckpt.restore(state_template=state)
    ckpt.close()
    torch.save({"saved": saved, "restored": restored, "in_place": restored["params"]["w"] is
                state["params"]["w"], "record": ckpt.saved[0], "last_restore": ckpt.last_restore},
               os.path.join(tmp, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_worker(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import jax.numpy as jnp  # noqa: E402
from test_torch_parallel import REPO, spawn_world  # noqa: E402

from torchft_tpu.checkpointing import DurableCheckpointer as RefCheckpointer  # noqa: E402
from torchft_tpu_torch.checkpointing import DurableCheckpointer  # noqa: E402
from torchft_tpu_torch.data import DistributedSampler, StatefulDataIterator  # noqa: E402


class FakeManagerState:
    def __init__(self, step=7, batches=14):
        self._sd = {"step": step, "batches_committed": batches}

    def state_dict(self):
        return dict(self._sd)


def make_state():
    return {
        "params": {
            "w": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "b": torch.ones(3, dtype=torch.bfloat16),
        },
        "opt": [torch.zeros(2, 4)],
    }


class TestRoundtrip:
    def test_save_restore_composite(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "ckpt"))
        state = make_state()
        data_iter = StatefulDataIterator(DistributedSampler(100, 0, 0, 1, 2))
        for _ in range(5):
            next(data_iter)
        assert ckpt.save(7, state, manager=FakeManagerState(), data_iter=data_iter)
        ckpt.wait()
        r_state, manager_sd, data_sd = ckpt.restore(state_template=make_state())
        assert torch.equal(r_state["params"]["w"], state["params"]["w"])
        assert r_state["params"]["b"].dtype == torch.bfloat16
        assert manager_sd == {"step": 7, "batches_committed": 14}
        fresh = StatefulDataIterator(DistributedSampler(100, 0, 0, 1, 2))
        fresh.load_state_dict(data_sd)
        assert fresh.state_dict() == data_iter.state_dict()
        ckpt.close()

    def test_restore_without_checkpoint_returns_none(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "empty"))
        assert ckpt.restore() is None
        ckpt.close()

    def test_state_only_checkpoint(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "s"))
        assert ckpt.save(1, {"x": torch.ones(2)})
        ckpt.wait()
        r_state, manager_sd, data_sd = ckpt.restore()
        assert r_state["x"].tolist() == [1.0, 1.0]
        assert manager_sd is None and data_sd is None
        ckpt.close()

    def test_restored_leaves_land_in_the_template(self, tmp_path):
        """With a template, each tensor lands in the template's tensor, in
        place on its device (the reference's device arrays come back as
        device arrays)."""
        ckpt = DurableCheckpointer(str(tmp_path / "d"))
        ckpt.save(3, make_state())
        ckpt.wait()
        template = {"params": {"w": torch.zeros(2, 4), "b": torch.zeros(3, dtype=torch.bfloat16)},
                    "opt": [torch.full((2, 4), 5.0)]}
        ptr = template["params"]["w"].data_ptr()
        r_state, _, _ = ckpt.restore(state_template=template)
        assert r_state["params"]["w"] is template["params"]["w"]
        assert template["params"]["w"].data_ptr() == ptr
        assert torch.equal(template["params"]["w"], make_state()["params"]["w"])
        assert isinstance(r_state["opt"][0], torch.Tensor)
        assert r_state["opt"][0].device == template["opt"][0].device
        assert torch.equal(template["opt"][0], torch.zeros(2, 4))
        with pytest.raises(ValueError, match="template"):
            ckpt.restore(state_template={"params": {"w": torch.zeros(4, 2)}})
        ckpt.close()


class TestFullUserComposite:
    """A durable checkpoint captures the composite a live heal moves,
    DiLoCo's fragment globals and outer momentum included."""

    def test_manager_user_state_dict_roundtrip_with_diloco(self, tmp_path):
        from test_torch_local_sgd import PortMock

        from torchft_tpu_torch.checkpointing import RWLock
        from torchft_tpu_torch.local_sgd import DiLoCo
        from torchft_tpu_torch.manager import Manager

        # a real Manager for its state-registration plumbing only
        mgr = Manager.__new__(Manager)
        mgr._state_dict_lock = RWLock(timeout=5.0)
        mgr._user_state_dicts = {}
        mgr._load_state_dict_fns = {}
        mgr._step, mgr._batches_committed = 0, 0

        trainer_state = {"params": {"w": torch.full((2,), 2.0)}}
        mgr.register_state_dict_fn("default", lambda sd: trainer_state.update(sd),
                                   lambda: dict(trainer_state))
        algo_mgr = PortMock()
        diloco = DiLoCo(algo_mgr, trainer_state["params"],
                        lambda ps: torch.optim.SGD(ps, lr=1.0, momentum=0.9), sync_every=2)
        for key, (load_fn, value_fn) in algo_mgr.state_fns.items():
            mgr.register_state_dict_fn(key, load_fn, value_fn)

        composite = mgr.user_state_dict()
        assert "default" in composite and "StreamingDiLoCoFragment_0" in composite
        ckpt = DurableCheckpointer(str(tmp_path / "full"))
        ckpt.save(5, composite, manager=mgr)
        ckpt.wait()

        # a cold restart: fresh fragment state, then the composite restored
        diloco.fragments[0].original[0].zero_()
        user_sd, manager_sd, _ = ckpt.restore(state_template=mgr.user_state_dict())
        mgr.load_user_state_dict(user_sd)
        assert diloco.fragments[0].original[0].tolist() == [2.0, 2.0]
        # the outer optimizer's state dict, int keys and all
        outer = user_sd["StreamingDiLoCoFragment_0"]["outer_optimizer"]
        assert outer["param_groups"][0]["params"] == [0]
        assert manager_sd == {"step": 0, "batches_committed": 0}
        ckpt.close()


class TestRetentionAndInterval:
    def test_max_to_keep(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "r"), max_to_keep=2)
        for step in (1, 2, 3, 4):
            ckpt.save(step, {"x": torch.full((2,), float(step))})
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]
        r_state, _, _ = ckpt.restore()
        assert r_state["x"].tolist() == [4.0, 4.0]
        ckpt.close()

    def test_maybe_save_interval(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "i"), max_to_keep=10, save_interval_steps=5)
        saves = [s for s in range(1, 13) if ckpt.maybe_save(s, {"x": torch.ones(1)})]
        ckpt.wait()
        assert saves == [5, 10]
        assert ckpt.latest_step() == 10
        assert not ckpt.maybe_save(10, {"x": torch.ones(1)})  # a step already latest
        ckpt.close()

    def test_step_zero_never_saved(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "s0"), save_interval_steps=5)
        assert not ckpt.maybe_save(0, {"x": torch.ones(1)})
        assert ckpt.latest_step() is None
        ckpt.close()

    def test_callable_state_materialized_only_on_save(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "lazy"), save_interval_steps=2)
        calls = []

        def state():
            calls.append(1)
            return {"x": torch.ones(1)}

        assert not ckpt.maybe_save(1, state)
        assert calls == []
        assert ckpt.maybe_save(2, state)
        assert calls == [1]
        # the step in flight is not issued twice
        assert not ckpt.maybe_save(2, state)
        ckpt.close()

    def test_interval_zero_never_autosaves(self, tmp_path):
        ckpt = DurableCheckpointer(str(tmp_path / "z"))
        assert not ckpt.maybe_save(5, {"x": torch.ones(1)})
        assert ckpt.latest_step() is None
        ckpt.close()


def _arrays(step: int) -> dict:
    rng = np.random.RandomState(step)
    return {"params": {"w": rng.randn(3, 5).astype(np.float32),
                       "b": rng.randn(7).astype(np.float32)},
            "opt": [rng.randn(3, 5).astype(np.float32), np.float32(step)]}


def test_parity_with_the_reference_through_one_call_sequence(tmp_path):
    """The same calls on both packages: equal steps after each (once the
    writes landed), equal restored manager and data dicts, and arrays
    restored bitwise as saved (bf16 too) in both."""
    from torchft_tpu.data import DistributedSampler as RefSampler
    from torchft_tpu.data import StatefulDataIterator as RefIterator

    ref = RefCheckpointer(str(tmp_path / "ref"), max_to_keep=2, save_interval_steps=2)
    port = DurableCheckpointer(str(tmp_path / "port"), max_to_keep=2, save_interval_steps=2)
    ref_it, port_it = (RefIterator(RefSampler(64, 0, 0, 1, 4)),
                       StatefulDataIterator(DistributedSampler(64, 0, 0, 1, 4)))
    saved = {}

    def as_ref(a):
        return {"params": {"w": jnp.asarray(a["params"]["w"]),
                           "b": jnp.asarray(a["params"]["b"]).astype(jnp.bfloat16)},
                "opt": [jnp.asarray(a["opt"][0]), jnp.asarray(a["opt"][1])]}

    def as_port(a):
        return {"params": {"w": torch.from_numpy(a["params"]["w"]),
                           "b": torch.from_numpy(a["params"]["b"]).bfloat16()},
                "opt": [torch.from_numpy(a["opt"][0]), torch.tensor(a["opt"][1])]}

    for step in range(0, 9):
        next(ref_it), next(port_it)
        a = _arrays(step)
        r = ref.maybe_save(step, lambda: as_ref(a), manager=FakeManagerState(step, 2 * step),
                           data_iter=ref_it)
        p = port.maybe_save(step, lambda: as_port(a), manager=FakeManagerState(step, 2 * step),
                            data_iter=port_it)
        ref.wait(), port.wait()
        assert r == p, step
        if p:
            saved[step] = a
        assert ref.all_steps() == port.all_steps() and ref.latest_step() == port.latest_step()
    assert port.all_steps() == [6, 8]
    # a step not after the latest is skipped, and a forced one saved
    # already raises; one off the interval lands
    for step in (7, 8):
        assert ref.save(step, as_ref(_arrays(step))) is port.save(step, as_port(_arrays(step))) \
            is False
    with pytest.raises(Exception, match="already exists"):
        ref.save(8, as_ref(_arrays(8)), force=True)
    with pytest.raises(FileExistsError, match="already exists"):
        port.save(8, as_port(_arrays(8)), force=True)
    assert ref.save(9, as_ref(_arrays(9)), manager=FakeManagerState(9, 18), data_iter=ref_it) \
        is port.save(9, as_port(_arrays(9)), manager=FakeManagerState(9, 18),
                     data_iter=port_it) is True
    ref.wait(), port.wait()
    saved[9] = _arrays(9)
    assert ref.all_steps() == port.all_steps() == [8, 9]
    for step in port.all_steps():
        r_state, r_mgr, r_data = ref.restore(step=step)
        p_state, p_mgr, p_data = port.restore(step=step)
        assert r_mgr == p_mgr == {"step": step, "batches_committed": 2 * step}
        assert r_data == p_data
        want = saved[step]
        for got_w, got_b in ((np.asarray(r_state["params"]["w"]), r_state["params"]["b"]),
                             (p_state["params"]["w"].numpy(), p_state["params"]["b"])):
            assert got_w.tobytes() == want["params"]["w"].tobytes()
        ref_b = np.asarray(jnp.asarray(r_state["params"]["b"]).view(jnp.uint16))
        port_b = p_state["params"]["b"].view(torch.int16).numpy().view(np.uint16)
        assert ref_b.tobytes() == port_b.tobytes()
        assert np.asarray(r_state["opt"][0]).tobytes() == p_state["opt"][0].numpy().tobytes() \
            == want["opt"][0].tobytes()
        assert float(r_state["opt"][1]) == float(p_state["opt"][1]) == step
    ref.close()
    port.close()


_KILLED_SAVER = textwrap.dedent("""
    import os, sys, time
    import torch
    from torchft_tpu_torch.checkpointing import durable

    directory, marker, mode = sys.argv[1:4]
    ckpt = durable.DurableCheckpointer(directory, save_interval_steps=1)
    ckpt.save(1, {"x": torch.full((1 << 20,), 1.0)})
    ckpt.wait()
    if mode == "hook":
        def hold(point, step):
            open(marker, "w").close()
            time.sleep(600)  # the parent kills us here
        durable.set_save_fault_hook(hold)
    else:
        open(marker, "w").close()
    ckpt.save(2, {"x": torch.full((1 << 24,), 2.0)})
    ckpt.wait()
    time.sleep(600)
""")


@pytest.mark.parametrize("mode", ["hook", "race"])
def test_a_save_killed_mid_write_never_becomes_the_latest(tmp_path, mode):
    """SIGKILL during a save: with ``hook`` the process dies after its
    tensors reached the disk and before the step was finished; with
    ``race`` it dies as soon as the save starts, wherever the write got to.
    The previous step stays the latest (or, if the write finished first,
    the new one, whole), and the next incarnation clears the debris."""
    directory, marker = str(tmp_path / "ckpt"), str(tmp_path / "marker")
    script = tmp_path / "saver.py"
    script.write_text(_KILLED_SAVER)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, str(script), directory, marker, mode], env=env)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(marker):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if mode == "hook":
        assert any(n.startswith(".tmp-") for n in os.listdir(directory))
    ckpt = DurableCheckpointer(directory)
    assert not any(n.startswith(".tmp-") for n in os.listdir(directory))
    latest = ckpt.latest_step()
    assert latest == 1 if mode == "hook" else latest in (1, 2)
    r_state, _, _ = ckpt.restore()
    assert torch.equal(r_state["x"], torch.full((1 << 20,) if latest == 1 else (1 << 24,),
                                                float(latest)))
    ckpt.close()


def test_two_ranks_restore_their_own_shards(tmp_path):
    """Two gloo ranks, different local shards under the same keys (as the
    HSDP trainer's): each restores its own, bitwise and in place, and the
    step is finished only once both wrote."""
    directory = str(tmp_path / "ckpt")
    outs = spawn_world(HERE, 2, {"dir": directory}, tmp_path)
    for rank, out in enumerate(outs):
        assert out["in_place"]
        for part in ("params", "opt"):
            for name, t in out["saved"][part].items():
                got = out["restored"][part][name]
                assert got.dtype == t.dtype
                assert torch.equal(got.reshape(-1).view(torch.uint8),
                                   t.reshape(-1).view(torch.uint8)), (rank, part, name)
        assert out["record"]["sha256"] == out["last_restore"]["sha256"]
    assert not torch.equal(outs[0]["restored"]["params"]["w"], outs[1]["restored"]["params"]["w"])
    assert sorted(os.listdir(os.path.join(directory, "5"))) == [
        "rank_0", "rank_0.json", "rank_1", "rank_1.json"]
