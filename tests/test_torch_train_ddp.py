"""The port's ``train_ddp`` example against the reference's
(``examples/train_ddp.py``, imported by path), on the CPU.

(a) One step: the CNN's loss and gradients on the reference's parameters
    (carried over by ``convert``) and batch, within 1e-5 relative (f32).
    Wrong layouts (``padding=1`` for JAX's SAME, an NCHW flatten into
    ``w1``) miss that bar, so the test tells them apart.
(b) A fault-free run: two replicas as threads, each package against its own
    lighthouse, 6 steps through each package's ``_train_loop``: the port's
    final parameters within 1e-4 relative (L2 per parameter) of the
    reference's, with ``--grad-accum 1`` and with ``--grad-accum 2
    --quantize``; within each package the replicas end bitwise equal.
(c) The example as processes: the lighthouse CLI and two replicas with
    ``--device cpu``, over HTTP and over PG. The test kills replica 1 with
    SIGKILL once it printed its step-3 line and restarts it. Every process
    exits with 0, the restarted replica heals mid-run, and both replicas'
    parameter checksums agree. The lighthouse holds the survivor in quorum
    (``--min-replicas 2``) until the restarted replica joins, so the rejoin
    always goes through a heal. On a wedge every process is killed and the
    transcript printed.
"""

import argparse
import importlib.util
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchft_tpu_torch.convert import cnn_momentum_from_jax, cnn_params_from_jax
from torchft_tpu_torch.examples import train_ddp as port_ex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_train_ddp", os.path.join(REPO, "examples", "train_ddp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("TORCHFT_COMPRESS", "TORCHFT_STREAM_BUCKETS", "TORCHFT_BUCKET_CAP_MB",
                "TORCHFT_LIGHTHOUSE", "REPLICA_GROUP_ID"):
        monkeypatch.delenv(var, raising=False)


def _port_trainer(ref_state, replica_id=0, batch_size=8, lr=0.01):
    """The port's trainer on the CPU, holding the reference's parameters
    and momentum."""
    model, grad_fn, optimizer, make_batch = port_ex.build_trainer(
        replica_id, batch_size, lr, device="cpu")
    model.load_state_dict(cnn_params_from_jax(ref_state["params"]))
    momentum = cnn_momentum_from_jax(ref_state["opt_state"])
    for name, p in model.named_parameters():
        optimizer.state[p]["momentum_buffer"].copy_(momentum[name])
    return model, grad_fn, optimizer, make_batch


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- (a) one step ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_one_step_loss_and_grads_match_the_reference(seed):
    state, grad_fn, _opt, make_batch = REF.build_trainer(seed, batch_size=8)
    x, y = make_batch()
    loss, grads = grad_fn(state["params"], x, y)
    model, port_grad_fn, _o, port_make_batch = _port_trainer(state, seed)
    px, py = port_make_batch()
    # the same RandomState draws as the reference's batch source
    np.testing.assert_array_equal(px.numpy(), np.asarray(x))
    np.testing.assert_array_equal(py.numpy(), np.asarray(y))
    ploss, pgrads = port_grad_fn(px, py)
    assert abs(float(ploss) - float(loss)) <= 1e-5 * abs(float(loss))
    for k in ("conv", "w1", "w2"):
        assert pgrads[k].shape == tuple(grads[k].shape)
        assert _rel(pgrads[k].numpy(), grads[k]) <= 1e-5, k


def _wrong_forward(model, x, padding_one, nchw_flatten):
    h = x.permute(0, 3, 1, 2)
    if padding_one:
        h = F.conv2d(h, model.conv.permute(3, 2, 0, 1), stride=2, padding=1)
    else:
        h = F.conv2d(F.pad(h, (0, 1, 0, 1)), model.conv.permute(3, 2, 0, 1), stride=2)
    h = F.relu(h)
    h = h.reshape(x.shape[0], -1) if nchw_flatten else h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.relu(h @ model.w1) @ model.w2


@pytest.mark.parametrize("padding_one,nchw_flatten", [(True, False), (False, True)],
                         ids=["padding_1", "nchw_flatten"])
def test_wrong_layouts_miss_the_bar(padding_one, nchw_flatten):
    """The parity bar tells the reference's layout from the two likely
    mistakes: each gives logits far outside 1e-5 of the reference's."""
    state, _g, _o, make_batch = REF.build_trainer(0, batch_size=8)
    x, _y = make_batch()
    model, *_ = _port_trainer(state)
    want = _ref_logits(state, x)
    with torch.no_grad():
        right = model(torch.from_numpy(np.array(x))).numpy()
        wrong = _wrong_forward(model, torch.from_numpy(np.array(x)), padding_one,
                               nchw_flatten).numpy()
    assert _rel(right, want) <= 1e-5
    assert _rel(wrong, want) > 1e-2


def _ref_logits(state, x):
    """The reference CNN's logits, by the JAX ops of its ``forward`` (local
    to ``build_trainer`` in ``examples/train_ddp.py``)."""
    import jax
    import jax.numpy as jnp

    params = state["params"]
    h = jax.lax.conv_general_dilated(
        jnp.asarray(x), params["conv"], window_strides=(2, 2), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    h = jax.nn.relu(h).reshape(x.shape[0], -1)
    return np.asarray(jax.nn.relu(h @ params["w1"]) @ params["w2"])


def test_momentum_carries_over_from_the_optax_trace():
    """After two reference SGD steps the optax trace is nonzero; the port's
    momentum buffers take it, and one more step on the same reduced
    gradient lands where the reference's does."""
    import jax
    import optax

    state, grad_fn, optimizer, make_batch = REF.build_trainer(3, batch_size=4)
    for _ in range(2):
        x, y = make_batch()
        _l, g = grad_fn(state["params"], x, y)
        upd, state["opt_state"] = optimizer.update(g, state["opt_state"], state["params"])
        state["params"] = optax.apply_updates(state["params"], upd)
    model, _gf, topt, _mb = _port_trainer(state, 3, batch_size=4)
    for name, p in model.named_parameters():
        assert topt.state[p]["momentum_buffer"].abs().sum() > 0
    x, y = make_batch()
    _l, g = grad_fn(state["params"], x, y)
    upd, _ = optimizer.update(g, state["opt_state"], state["params"])
    want = jax.tree_util.tree_map(np.asarray, optax.apply_updates(state["params"], upd))
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.asarray(g[name]).copy())
    topt.step()
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name]) <= 1e-6


def test_fresh_and_stepped_optimizers_carry_the_same_tree():
    """The momentum buffers exist, zero, before the first step: a heal at
    step 0 carries the tree a later heal carries (the in-place template
    then matches the sender's at every step)."""
    import torch.utils._pytree as pytree

    model, grad_fn, opt, make_batch = port_ex.build_trainer(0, 4, device="cpu")
    fresh = pytree.tree_structure(opt.state_dict())
    for name, p in model.named_parameters():
        assert not opt.state[p]["momentum_buffer"].any()
    _l, g = grad_fn(*make_batch())
    for name, p in model.named_parameters():
        p.grad = g[name]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    assert pytree.tree_structure(opt.state_dict()) == fresh
    # the first step from zero buffers is plain SGD: p - lr * g
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[name] - 0.01 * g[name], rtol=0, atol=1e-7)


# -- (b) a fault-free two-replica run ---------------------------------------------

STEPS = 6


def _run_reference(args):
    import jax
    import jax.numpy as jnp

    from torchft_tpu.coordination import LighthouseServer
    from torchft_tpu.manager import Manager
    from torchft_tpu.process_group import ProcessGroupHost

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                          quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def replica(rid):
        state, grad_fn, optimizer, _mb = REF.build_trainer(rid, args.batch_size, args.lr)
        opt_state = state["opt_state"]

        def load_state(sd):
            state["params"] = jax.tree_util.tree_map(jnp.asarray, sd["params"])
            state["opt_state"] = jax.tree_util.tree_map(
                lambda t, x: jnp.asarray(x) if hasattr(t, "dtype") else x, opt_state,
                sd["opt_state"])

        manager = Manager(pg=ProcessGroupHost(timeout=30.0), load_state_dict=load_state,
                          state_dict=lambda: {"params": state["params"],
                                              "opt_state": state["opt_state"]},
                          min_replica_size=1, replica_id=f"train_ddp_{rid}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=30.0)
        try:
            REF._train_loop(args, manager, state, grad_fn, optimizer,
                            np.random.RandomState(rid), rid)
            return {k: np.asarray(v) for k, v in state["params"].items()}
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(2) as ex:
            return [f.result(timeout=240) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def _run_port(args):
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                          quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def replica(rid):
        state, *_ = REF.build_trainer(rid, args.batch_size, args.lr)
        model, grad_fn, optimizer, _mb = _port_trainer(state, rid, args.batch_size, args.lr)

        def load_state(sd):
            model.load_state_dict(sd["params"])
            optimizer.load_state_dict(sd["opt_state"])

        manager = Manager(pg=ProcessGroupHost(timeout=30.0), load_state_dict=load_state,
                          state_dict=lambda: {"params": model.state_dict(),
                                              "opt_state": optimizer.state_dict()},
                          min_replica_size=1, replica_id=f"train_ddp_{rid}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=30.0)
        try:
            port_ex._train_loop(args, manager, model, grad_fn, optimizer,
                                np.random.RandomState(rid), rid)
            return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(2) as ex:
            return [f.result(timeout=240) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


@pytest.mark.parametrize("grad_accum,quantize", [(1, False), (2, True)],
                         ids=["accum1", "accum2_quantize"])
def test_fault_free_run_matches_the_reference(grad_accum, quantize):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = argparse.Namespace(steps=STEPS, batch_size=8, lr=0.01, grad_accum=grad_accum,
                                  quantize=quantize)
        ref = _run_reference(args)
        port = _run_port(args)
    finally:
        torch.set_num_threads(n)
    for k in ("conv", "w1", "w2"):
        np.testing.assert_array_equal(ref[0][k], ref[1][k])
        np.testing.assert_array_equal(port[0][k], port[1][k])
        assert _rel(port[0][k], ref[0][k]) <= 1e-4, k


# -- (c) the demo as processes ----------------------------------------------------

DEADLINE_S = 120


def _sigkill_demo(transport, lighthouse_argv=(), **env):
    """Two replica processes, replica 1 SIGKILLed after its step 3 and
    restarted; returns (exit codes, done lines, lighthouse exit code, the
    transcript's tail, replica 1's first step line)."""
    kill_at, steps = 3, 8
    fleet = port_ex.Fleet(
        ["--steps", str(steps), "--batch-size", "4", "--device", "cpu",
         "--transport", transport],
        ["--min-replicas", "2", "--join-timeout-ms", "500", "--quorum-tick-ms", "20",
         "--heartbeat-timeout-ms", "2000", *lighthouse_argv],
        env=dict(os.environ, OMP_NUM_THREADS="1", **env),
    )
    deadline = time.monotonic() + DEADLINE_S
    left = lambda: max(1.0, deadline - time.monotonic())  # noqa: E731
    try:
        for rid in (0, 1):
            fleet.spawn(rid)
        fleet.wait_line(1, f"] step={kill_at} ", left())
        fleet.kill(1)
        fleet.spawn(1)
        rcs = fleet.wait(left())
        done = {rid: fleet.done(rid) for rid in (0, 1)}
    except BaseException as e:
        fleet.close()
        raise AssertionError(f"{e!r}\n--- transcript ---\n" + "\n".join(fleet.transcript[-200:]))
    lighthouse_rc = fleet.close()
    transcript = "\n".join(fleet.transcript[-200:])
    first = next(line for line in fleet.lines[1] if "] step=" in line)
    return rcs, done, lighthouse_rc, transcript, first


@pytest.mark.parametrize("transport", ["http", "pg"])
def test_processes_survive_a_sigkill_and_heal(transport):
    kill_at, steps = 3, 8
    rcs, done, lighthouse_rc, transcript, first = _sigkill_demo(transport)
    assert rcs == {0: 0, 1: 0} and lighthouse_rc == 0, transcript
    assert int(first.split("step=", 1)[1].split()[0]) > kill_at, transcript
    assert done[1]["metrics"]["heals"] >= 1, transcript
    assert done[0]["step"] == done[1]["step"] == steps
    assert done[0]["params_sha256"] == done[1]["params_sha256"], transcript
    if transport == "pg":
        assert done[1]["timings"]["heal_chunks"] >= 1


def test_processes_record_policy_intents_in_observe_mode():
    """The same demo with the lighthouse CLI's ``--policy builtin`` and
    ``TORCHFT_POLICY=observe`` everywhere: the "calm" rule's frame reaches
    both replicas, each records an intent and applies nothing, and they
    still end bitwise equal."""
    rcs, done, lighthouse_rc, transcript, _ = _sigkill_demo(
        "http", ("--policy", "builtin"), TORCHFT_POLICY="observe",
        TORCHFT_POLICY_INTERVAL_S="0.25")
    assert rcs == {0: 0, 1: 0} and lighthouse_rc == 0, transcript
    assert "policy engine attached (spec=builtin mode=observe)" in transcript
    for d in done.values():
        assert d["policy_intents"] >= 1 and d["policy_applies"] == 0, d
    assert done[0]["policy_seq"] == done[1]["policy_seq"] >= 1
    assert done[0]["params_sha256"] == done[1]["params_sha256"], transcript


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ex.build_trainer(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ex.main(["--steps", "1"])


# -- (d) the Llama trainer's heal over PGTransport -------------------------------

def test_trainer_heals_over_pg_as_over_http_and_frees_the_crashed_replica(monkeypatch):
    """``TrainConfig(transport="pg")``: the debug Llama with a crash of
    replica 1 at step 2 ends bitwise where the HTTP heal ends (the
    replicas equal), with the heal received in place; and the crashed
    incarnation's model is collected before its restart builds a new one
    (its template closure keeps it in a reference cycle, which on the card
    held a second model, optimizer state and residuals)."""
    import weakref

    from torchft_tpu_torch import train

    built = []
    build = train.build_trainer

    def recording(cfg, replica_id, device):
        if replica_id == 1 and built:
            gc_free = [ref() is None for ref in built]
            recording.collected.append(all(gc_free))
        model, optim, make_batch = build(cfg, replica_id, device)
        if replica_id == 1:
            built.append(weakref.ref(model))
        return model, optim, make_batch

    recording.collected = []
    monkeypatch.setattr(train, "build_trainer", recording)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        finals = {}
        for transport in ("http", "pg"):
            built.clear()
            cfg = train.TrainConfig(config="debug", steps=4, seq_len=16, quantize=True,
                                    faults=(train.Fault(1, 2, "crash", at="backward"),),
                                    transport=transport)
            results = train.run_replicas(cfg, "cpu")
            assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
            for k, v in results[0]["params"].items():
                assert torch.equal(v, results[1]["params"][k])
            finals[transport] = results[0]["params"]
            if transport == "pg":
                assert results[1]["timings"]["heal_chunks"] >= 1
    finally:
        torch.set_num_threads(n)
    for k, v in finals["http"].items():
        assert torch.equal(finals["pg"][k], v), k
    assert recording.collected == [True, True]
    with pytest.raises(ValueError, match="transport"):
        train.run_replicas(train.TrainConfig(config="debug", transport="ftp"), "cpu")


def test_trainer_restarts_only_once_a_late_thread_released_the_crashed_replica(monkeypatch):
    """The race behind the test above failing under a loaded host: the
    crashed incarnation's quorum thread still runs when the replica
    restarts (here made to return 1 s late), holding its Manager and, through
    the state-dict closure, its model. The trainer waits for their release
    before it builds the next model, so the model is collected first."""
    import time
    import weakref

    from torchft_tpu_torch import train
    from torchft_tpu_torch.manager import Manager

    orig = Manager._async_quorum

    def late(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if self._replica_id.startswith("replica_1") and self._step == 2:
            time.sleep(1.0)
        return out

    built, collected = [], []
    build = train.build_trainer

    def recording(cfg, replica_id, device):
        if replica_id == 1 and built:
            collected.append(all(ref() is None for ref in built))
        model, optim, make_batch = build(cfg, replica_id, device)
        if replica_id == 1:
            built.append(weakref.ref(model))
        return model, optim, make_batch

    monkeypatch.setattr(Manager, "_async_quorum", late)
    monkeypatch.setattr(train, "build_trainer", recording)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = train.TrainConfig(config="debug", steps=4, seq_len=16, quantize=True,
                                faults=(train.Fault(1, 2, "crash", at="backward"),))
        results = train.run_replicas(cfg, "cpu")
    finally:
        torch.set_num_threads(n)
    assert results[1]["restarts"] == 1
    assert collected == [True]
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k])


# -- (e) the Llama trainer's fault script ------------------------------------------

def test_trainer_fault_script_heals_through_failover_and_crc(monkeypatch):
    """The resilient-heal script the card runs at bench_1b (the reference's
    ``TestResilientHeal``), on the debug Llama with three replicas: replica
    2 crashes at the start of step 2; its assigned source drops every serve
    of chunk 0, so the heal fails over to the standby, which corrupts
    chunk 0 once; one should_commit RPC flakes at step 4. Every replica
    reaches step 6 bitwise equal, the heal failed over and caught the crc
    failure with no error, an RPC was retried and the storage kept."""
    from torchft_tpu_torch import train
    from torchft_tpu_torch.train import Fault

    monkeypatch.setenv("TORCHFT_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("TORCHFT_RETRY_BASE_S", "0.01")
    faults = (
        Fault(2, 2, "crash"),
        Fault(0, 2, "kill_heal_chunk", chunk=0, times=-1),
        Fault(1, 2, "corrupt_heal_chunk", chunk=0, times=1),
        Fault(0, 4, "flake_rpc", method="should_commit"),
    )
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = train.TrainConfig(config="debug", steps=6, seq_len=16, quantize=False,
                                transport="http", replicas=3, http_timeout=3.0, faults=faults)
        results = train.run_replicas(cfg, "cpu")
    finally:
        torch.set_num_threads(n)
    assert [r["step"] for r in results] == [6, 6, 6]
    assert [r["restarts"] for r in results] == [0, 0, 1]
    healed = results[2]
    assert healed["metrics"]["heals"] >= 1 and healed["metrics"]["errors"] == 0
    assert healed["timings"]["heal_failovers"] >= 1
    assert healed["timings"]["chunk_crc_failures"] >= 1
    assert sum(r["timings"]["rpc_retries"] for r in results) >= 1
    assert all(r["storage_kept"] for r in results)
    for r in results[1:]:
        for k, v in results[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k


def test_trainer_fault_script_fires_under_diloco(monkeypatch):
    """Under ``diloco=True`` the script fires too, at either point of an
    inner step: a crash at the start of inner step 5 heals, an RPC flake
    after inner step 2's backward pass is retried, and the fragments'
    state ends bitwise equal."""
    from torchft_tpu_torch import train
    from torchft_tpu_torch.train import Fault

    monkeypatch.setenv("TORCHFT_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("TORCHFT_RETRY_BASE_S", "0.01")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = train.TrainConfig(
            config="debug", steps=8, seq_len=16, quantize=False, transport="http",
            diloco=True, sync_every=4, num_fragments=2, fragment_sync_delay=1,
            faults=(Fault(1, 5, "crash"),
                    Fault(0, 2, "flake_rpc", method="should_commit", at="backward")))
        results = train.run_replicas(cfg, "cpu")
    finally:
        torch.set_num_threads(n)
    assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
    assert sum(r["timings"]["rpc_retries"] for r in results) >= 1
    assert results[0]["step"] == results[1]["step"]
    s0, s1 = results[0]["fragment_state"], results[1]["fragment_state"]
    assert len(s0) == len(s1) and all(torch.equal(a, b) for a, b in zip(s0, s1))


@pytest.mark.parametrize("bad", [{"kind": "explode"}, {"kind": "crash", "at": "end"}])
def test_fault_rejects_unknown_kinds_and_points(bad):
    from torchft_tpu_torch.train import Fault

    with pytest.raises(ValueError, match="unknown fault"):
        Fault(0, 1, **bad)


def test_trainer_cuts_the_depth_at_full_width():
    """``TrainConfig(layers=N)`` (``--layers N``) trains the config cut to N
    layers at its own width: the cut ``chip_smoke.py`` makes to the depth of
    earlier phases. Two replicas train it to the end, equal."""
    from torchft_tpu_torch import train
    from torchft_tpu_torch.models.llama import CONFIGS

    cfg = train.TrainConfig(config="debug", layers=1, steps=2, seq_len=16, quantize=False)
    cut, _, _ = train.build_trainer(cfg, 0, torch.device("cpu"))
    full, _, _ = train.build_trainer(train.TrainConfig(config="debug"), 0, torch.device("cpu"))
    assert len(cut.layers) == 1 and len(full.layers) == CONFIGS["debug"].n_layers
    shapes = dict((n, p.shape) for n, p in full.named_parameters())
    assert all(shapes[n] == p.shape for n, p in cut.named_parameters())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = train.run_replicas(cfg, "cpu")
    finally:
        torch.set_num_threads(n)
    assert [r["step"] for r in results] == [2, 2]
    assert not any(k.startswith("layers.1.") for k in results[0]["params"])
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
