"""The port's ``train_diloco`` example and the trainer's ``--diloco`` mode,
on the CPU.

(a) A fault-free run: two replicas as threads, each package against its
    own lighthouse, the example's loop in the port (``_train_loop``) and
    the same loop written here in JAX after ``examples/train_diloco.py``
    (whose loop sits inside its ``train``), both from the reference MLP's
    initial parameters (``convert.mlp_params_from_jax``) and the same
    batches. The port's fragment globals end within a relative L2 gap of
    1e-5 of the reference's (AdamW's arithmetic differs between optax and
    torch in the last bits; measured on the CPU: 9.4e-7 with delay 0), and
    of 1e-4 with fp8 pseudogradients, where a last-bit difference can turn
    an fp8 code (measured: 2.8e-5 with delay 1), within each package the
    replicas bitwise equal.
(b) The example as processes: ``--demo`` (the lighthouse CLI, two
    replicas, a SIGKILL and a restart) exits 0, the restarted replica
    healed and the fragment digests agree.
(c) ``python -m torchft_tpu_torch.train --config debug --diloco`` with a
    crash at inner step 5, over HTTP and over PG: the replicas end with
    bitwise-equal fragment state, the same over both transports, and the
    surviving replica's prepare/perform schedule is the one the reference
    ``DiLoCo`` gives at the same cadence.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu_torch import train
from torchft_tpu_torch.convert import mlp_params_from_jax
from torchft_tpu_torch.examples import train_diloco as port_ex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_SYNC_EVERY", "TORCHFT_USE_BUCKETIZATION", "TORCHFT_COMPRESS",
                "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB", "TORCHFT_LIGHTHOUSE",
                "REPLICA_GROUP_ID"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_init(replica_id):
    """``init_params`` of ``examples/train_diloco.py`` (local to its
    ``train``)."""
    import jax
    import jax.numpy as jnp

    dims = [32, 64, 64, 64, 10]
    keys = jax.random.split(jax.random.PRNGKey(replica_id), len(dims) - 1)
    return {
        f"layer{i}": {
            "w": jax.random.normal(keys[i], (dims[i], dims[i + 1]), jnp.float32)
            * (1.0 / np.sqrt(dims[i])),
            "b": jnp.zeros((dims[i + 1],), jnp.float32),
        }
        for i in range(len(dims) - 1)
    }


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_mlp_matches_the_reference_forward():
    import jax

    params = _ref_init(3)
    model, _opt = port_ex.build_trainer(3, device="cpu")
    model.load_state_dict(mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    x, y = port_ex.draw_batch(np.random.RandomState(3), 16, torch.device("cpu"))
    h = np.asarray(x.numpy())
    for i in range(4):
        h = h @ np.asarray(params[f"layer{i}"]["w"]) + np.asarray(params[f"layer{i}"]["b"])
        if i < 3:
            h = np.maximum(h, 0)
    with torch.no_grad():
        assert _rel(model(x).numpy(), h) <= 1e-5
    # the sorted flatten matches the reference's leaf order
    assert sorted(dict(model.named_parameters())) == [
        f"layer{i}.{n}" for i in range(4) for n in ("b", "w")]


# -- (a) a fault-free run against the loop in JAX ----------------------------------

def _jax_run(args):
    import jax
    import jax.numpy as jnp
    import optax

    from torchft_tpu.coordination import LighthouseServer
    from torchft_tpu.local_sgd import DiLoCo
    from torchft_tpu.manager import Manager
    from torchft_tpu.process_group import ProcessGroupHost

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                          quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def forward(params, x):
        h = x
        for i in range(4):
            h = h @ params[f"layer{i}"]["w"] + params[f"layer{i}"]["b"]
            if i < 3:
                h = jax.nn.relu(h)
        return h

    def loss_fn(params, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(forward(params, x), y).mean()

    inner_tx = optax.adamw(1e-3)

    def _inner(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = inner_tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    inner_step = jax.jit(_inner)

    def replica(rid):
        state = {"params": _ref_init(rid)}
        state["inner"] = inner_tx.init(state["params"])

        def load_state(sd):
            state["params"] = jax.tree_util.tree_map(jnp.asarray, sd["params"])

        manager = Manager(pg=ProcessGroupHost(timeout=30.0), load_state_dict=load_state,
                          state_dict=lambda: {"params": state["params"]}, min_replica_size=1,
                          use_async_quorum=False, replica_id=f"train_diloco_{rid}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=30.0)
        try:
            diloco = DiLoCo(manager, state["params"],
                            outer_tx=optax.sgd(args.outer_lr, momentum=0.9, nesterov=True),
                            sync_every=args.sync_every, num_fragments=args.num_fragments,
                            fragment_sync_delay=args.fragment_sync_delay,
                            should_quantize=args.quantize, get_params=lambda: state["params"])
            rng = np.random.RandomState(rid)
            target = args.steps // args.sync_every * args.num_fragments
            while manager.current_step() < target:
                x = jnp.asarray(rng.randn(args.batch_size, 32), jnp.float32)
                y = jnp.asarray(rng.randint(0, 10, size=(args.batch_size,)))
                state["params"], state["inner"], _loss = inner_step(
                    state["params"], state["inner"], x, y)
                state["params"] = diloco.step(state["params"])
            state["params"] = diloco.flush(state["params"])
            return [np.asarray(p) for f in diloco.fragments for p in f.original]
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(2) as ex:
            return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def _port_run(args):
    import jax

    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                          quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def replica(rid):
        model, optimizer = port_ex.build_trainer(rid, device="cpu")
        model.load_state_dict(
            mlp_params_from_jax(jax.tree_util.tree_map(np.asarray, _ref_init(rid))))
        manager = Manager(pg=ProcessGroupHost(timeout=30.0),
                          load_state_dict=lambda sd: model.load_state_dict(sd["params"]),
                          state_dict=lambda: {"params": model.state_dict()}, min_replica_size=1,
                          use_async_quorum=False, replica_id=f"train_diloco_{rid}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=30.0)
        try:
            diloco = port_ex.make_diloco(args, manager, dict(model.named_parameters()))
            port_ex._train_loop(args, manager, diloco, model, optimizer,
                                np.random.RandomState(rid), rid)
            return [p.detach().numpy().copy() for f in diloco.fragments for p in f.original]
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(2) as ex:
            return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


@pytest.mark.parametrize("delay,quantize", [(0, False), (1, True)],
                         ids=["delay0", "delay1_quantize"])
def test_fault_free_run_matches_the_loop_in_jax(delay, quantize):
    args = argparse.Namespace(steps=16, batch_size=16, outer_lr=0.7, sync_every=4,
                              num_fragments=2, fragment_sync_delay=delay,
                              fragment_update_alpha=0.0, quantize=quantize)
    ref = _jax_run(args)
    port = _port_run(args)
    for a, b in zip(ref[0], ref[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port[0], port[1]):
        np.testing.assert_array_equal(a, b)
    gap = _rel(np.concatenate([p.ravel() for p in port[0]]),
               np.concatenate([p.ravel() for p in ref[0]]))
    assert gap <= (1e-4 if quantize else 1e-5), gap


# -- (b) the demo as processes ----------------------------------------------------

DEADLINE_S = 90


def test_demo_survives_a_sigkill_and_heals():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.examples.train_diloco", "--demo",
         "--device", "cpu", "--quantize", "--steps", "24", "--kill-at-outer-step", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=DEADLINE_S,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-6000:]
    assert "restarted replica healed: True; fragment digests agree: True" in out, out[-6000:]
    assert "--- killing replica 1 ---" in out and "--- restarting replica 1 ---" in out


def test_processes_heal_mid_run_with_equal_fragment_state():
    """The processes driven here, replica 1 killed after its outer-step-4
    line: it rejoins mid-run, heals, and ends with replica 0's fragment
    state; each ``done:`` line carries the reference's ``global_l1[frag0]``."""
    kill_at = 4
    fleet = port_ex_fleet(["--steps", "24", "--batch-size", "16", "--device", "cpu"])
    deadline = time.monotonic() + DEADLINE_S
    left = lambda: max(1.0, deadline - time.monotonic())  # noqa: E731
    try:
        for rid in (0, 1):
            fleet.spawn(rid)
        fleet.wait_line(1, f"] outer_step={kill_at} ", left())
        fleet.kill(1)
        fleet.spawn(1)
        rcs = fleet.wait(left())
        done = {rid: fleet.done(rid) for rid in (0, 1)}
    except BaseException as e:
        fleet.close()
        raise AssertionError(f"{e!r}\n--- transcript ---\n" + "\n".join(fleet.transcript[-200:]))
    lighthouse_rc = fleet.close()
    transcript = "\n".join(fleet.transcript[-200:])
    assert rcs == {0: 0, 1: 0} and lighthouse_rc == 0, transcript
    first = next(line for line in fleet.lines[1] if "] outer_step=" in line)
    assert int(first.split("outer_step=", 1)[1].split()[0]) > kill_at, transcript
    assert done[1]["metrics"]["heals"] >= 1, transcript
    assert done[0]["step"] == done[1]["step"] == 24 // 4 * 2
    assert done[0]["fragments_sha256"] == done[1]["fragments_sha256"], transcript
    assert done[0]["global_l1[frag0]"] == done[1]["global_l1[frag0]"] > 0


def port_ex_fleet(argv):
    from torchft_tpu_torch.examples.train_ddp import Fleet

    return Fleet(argv, ["--min-replicas", "2", "--join-timeout-ms", "500",
                        "--quorum-tick-ms", "20", "--heartbeat-timeout-ms", "2000"],
                 env=dict(os.environ, OMP_NUM_THREADS="1"),
                 module="torchft_tpu_torch.examples.train_diloco")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ex.build_trainer(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ex.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", "debug", "--diloco", "--steps", "1"])


# -- (c) the trainer's --diloco ------------------------------------------------------

CLI = ["--config", "debug", "--seq-len", "16", "--diloco", "--sync-every", "4",
       "--num-fragments", "2", "--fragment-sync-delay", "1", "--steps", "12", "--fail-at", "5",
       "--device", "cpu"]


def _reference_schedule(steps, sync_every, num_fragments, delay):
    """What the reference DiLoCo does at each inner step of a run where
    every sync commits: ["prepare:f"] / ["perform:f"] lists."""
    import optax

    from torchft_tpu import local_sgd as ref

    class Mock:
        _use_async_quorum = False

        def __init__(self):
            self.step = 0

        def start_quorum(self):
            pass

        def last_quorum_healed(self):
            return False

        def allreduce(self, values, should_quantize=False, reduce_op=None):
            from torchft_tpu.work import DummyWork

            return DummyWork([np.array(v, copy=True) for v in values])

        def should_commit(self):
            self.step += 1
            return True

        def current_step(self):
            return self.step

        def register_state_dict_fn(self, *a):
            pass

    events = []
    params = {"a": np.zeros(3, np.float32), "b": np.zeros(5, np.float32)}
    d = ref.DiLoCo(Mock(), params, optax.sgd(0.7), sync_every=sync_every,
                   num_fragments=num_fragments, fragment_sync_delay=delay)
    for frag in d.fragments:
        for kind in ("prepare_sync", "perform_sync"):
            orig = getattr(frag, kind)

            def spy(leaves, orig=orig, kind=kind, fid=frag._id):
                events[-1].append(f"{kind.split('_')[0]}:{fid}")
                return orig(leaves)

            setattr(frag, kind, spy)
    for _ in range(steps):
        events.append([])
        params = d.step(params)
    return events


def test_trainer_diloco_heals_over_both_transports_with_the_reference_schedule(capsys):
    digests = {}
    for transport in ("http", "pg"):
        train.main(CLI + ["--transport", transport])
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("{")]
        finals = [e for e in lines if "fragments_sha256" in e]
        assert [e["replica"] for e in finals] == [0, 1]
        assert finals[1]["restarts"] == 1 and finals[1]["metrics"]["heals"] >= 1
        # main() fails when the replicas' fragment state differs
        digests[transport] = {e["fragments_sha256"] for e in finals}
        steps = sorted((e for e in lines if e.get("replica") == 0 and "inner_step" in e),
                       key=lambda e: e["inner_step"])
        assert [e["inner_step"] for e in steps] == list(range(12))
        assert [e["sync"] for e in steps] == _reference_schedule(12, 4, 2, 1)
        assert all(e["committed"] for e in steps if "committed" in e)
    assert len(digests["http"]) == 1 and digests["http"] == digests["pg"]
