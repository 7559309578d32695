"""The port's fault-tolerant training slice against the JAX package's.

Two replica groups run as threads against an in-process lighthouse in each
package: the debug Llama config, the fp8-quantized managed allreduce at
both Managers' defaults (streamed fp8 buckets with error feedback), SGD,
the same initial parameters and batches, and a crash of
replica 1 after its backward pass at step 2 (once its step-2 quorum is
in: a crash before it reached the lighthouse would leave the survivor's
step undisturbed) that restarts and heals over HTTP. The lighthouse needs both replicas for a quorum, so the survivor
waits for the restart and the rejoin always heals.

Held: the per-replica commit/discard sequences are identical across
packages; replicas are bitwise equal within each package; final params
agree across packages within ``LR * (steps) * 2 * 32 * s_max``, i.e. per
committed step at most one e4m3 code step (32 units of the scale at the
top of the range) of the largest row scale ``s_max`` in each of the two
quantization stages, times the learning rate. The allreduce itself is
bitwise equal across packages when both get identical gradients, streamed
or serial (``stream_buckets=False``).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.coordination import LighthouseServer as JaxLighthouse
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu.models import llama as jl
from torchft_tpu.process_group import ProcessGroupHost as JaxPGHost
from torchft_tpu_torch import convert
from torchft_tpu_torch.checkpointing import HTTPTransport, PGTransport
from torchft_tpu_torch.checkpointing._serialization import flatten_state, unflatten_state
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.process_group import ProcessGroupHost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from intra-op threads; one keeps these
    tests from crowding the timing-sensitive tests of parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 4
FAIL_AT = 2
LR = 0.05
TIMEOUT = 30.0


class Crash(Exception):
    pass


def _lighthouse(cls):
    return cls(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=500,
               quorum_tick_ms=20, heartbeat_timeout_ms=3000)


def _init_trees():
    cfg = jl.CONFIGS["debug"]
    return [
        jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(r), cfg))
        for r in range(2)
    ]


def _batch(rid: int, step: int):
    rng = np.random.RandomState(1000 * rid + step)
    toks = rng.randint(0, 256, (2, 17)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _run(replica_fn):
    failed = threading.Event()
    logs = [[], []]

    def replica(rid):
        while True:
            try:
                return replica_fn(rid, failed, logs[rid])
            except Crash:
                continue

    with ThreadPoolExecutor(max_workers=2) as ex:
        finals = [f.result(timeout=180) for f in [ex.submit(replica, r) for r in range(2)]]
    return finals, logs


def _jax_slice(addr, inits):
    cfg = jl.CONFIGS["debug"]
    grad_fn = jax.jit(jax.value_and_grad(lambda p, t, y: jl.llama_loss(p, t, y, cfg)))
    scales = []

    def replica(rid, failed, log):
        state = {"params": jax.tree_util.tree_map(jnp.asarray, inits[rid])}

        def load(sd):
            state["params"] = jax.tree_util.tree_map(jnp.asarray, sd["params"])

        manager = JaxManager(
            pg=JaxPGHost(timeout=TIMEOUT), load_state_dict=load,
            state_dict=lambda: {"params": state["params"]}, min_replica_size=1,
            replica_id=f"replica_{rid}", lighthouse_addr=addr, timeout=TIMEOUT,
            quorum_timeout=TIMEOUT,
        )
        try:
            while manager.current_step() < STEPS:
                step = manager.current_step()
                manager.start_quorum()
                tokens, targets = _batch(rid, step)
                _, grads = grad_fn(state["params"], jnp.asarray(tokens), jnp.asarray(targets))
                if rid == 1 and step == FAIL_AT and not failed.is_set():
                    failed.set()
                    # in the step's quorum before it dies, so the survivor's
                    # step always sees the crash
                    manager.wait_quorum()
                    raise Crash()
                reduced = manager.allreduce(grads, should_quantize=True).get_future().wait(TIMEOUT)
                committed = manager.should_commit()
                if committed:
                    scales.append(max(float(jnp.abs(g).max()) for g in jax.tree_util.tree_leaves(reduced)))
                    state["params"] = jax.tree_util.tree_map(
                        lambda p, g: p - LR * g, state["params"], reduced
                    )
                log.append((step, committed))
            return jax.tree_util.tree_map(np.asarray, state["params"])
        finally:
            manager.shutdown(wait=False)

    finals, logs = _run(replica)
    return finals, logs, max(scales) / 448.0


def _torch_slice(addr, inits, transport="http", ptrs=None):
    """The port's slice; with ``transport="pg"`` the heal rides a
    PGTransport over a recovery PG into the live model (``ptrs`` collects
    each incarnation's parameter storage before and after)."""
    cfg = tl.CONFIGS["debug"]

    def replica(rid, failed, log):
        model = tl.Llama(cfg, device="cpu", attention="xla")
        model.load_state_dict(convert.llama_params_from_jax(inits[rid]))
        optim = torch.optim.SGD(model.parameters(), lr=LR)
        checkpoint_transport = recovery_pg = manager = None
        if transport == "pg":
            recovery_pg = ProcessGroupHost(timeout=TIMEOUT)
            checkpoint_transport = PGTransport(
                recovery_pg, timeout=TIMEOUT,
                state_dict_template=lambda: manager.state_dict_template())
        manager = Manager(
            pg=ProcessGroupHost(timeout=TIMEOUT),
            load_state_dict=lambda sd: model.load_state_dict(sd["model"]),
            state_dict=lambda: {"model": model.state_dict()}, min_replica_size=1,
            replica_id=f"replica_{rid}", lighthouse_addr=addr, timeout=TIMEOUT,
            quorum_timeout=TIMEOUT, checkpoint_transport=checkpoint_transport,
        )
        before = [p.data_ptr() for p in model.parameters()]
        optimizer = OptimizerWrapper(manager, optim)
        try:
            while manager.current_step() < STEPS:
                step = manager.current_step()
                optimizer.zero_grad()
                tokens, targets = (torch.from_numpy(a).long() for a in _batch(rid, step))
                model.loss(tokens, targets).backward()
                if rid == 1 and step == FAIL_AT and not failed.is_set():
                    failed.set()
                    # in the step's quorum before it dies, so the survivor's
                    # step always sees the crash
                    manager.wait_quorum()
                    raise Crash()
                grads = {n: p.grad for n, p in model.named_parameters()}
                avg = manager.allreduce(grads, should_quantize=True).get_future().wait(TIMEOUT)
                for n, p in model.named_parameters():
                    p.grad = avg[n]
                log.append((step, optimizer.step()))
            if ptrs is not None:
                ptrs.append((before, [p.data_ptr() for p in model.parameters()]))
            return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        finally:
            manager.shutdown(wait=False)
            if recovery_pg is not None:
                recovery_pg.shutdown()

    return _run(replica)


def _as_state_dict(tree):
    return {k: v.numpy() for k, v in convert.llama_params_from_jax(tree).items()}


def test_crash_heal_slice_matches_reference():
    inits = _init_trees()
    jlh = _lighthouse(JaxLighthouse)
    try:
        jfinals, jlogs, s_max = _jax_slice(f"127.0.0.1:{jlh.port}", inits)
    finally:
        jlh.shutdown()
    tlh = _lighthouse(LighthouseServer)
    try:
        tfinals, tlogs = _torch_slice(f"127.0.0.1:{tlh.port}", inits)
    finally:
        tlh.shutdown()

    assert tlogs == jlogs
    # replica 0 discarded the step replica 1 crashed in, then committed it
    assert (FAIL_AT, False) in tlogs[0] and (FAIL_AT, True) in tlogs[0]
    assert tlogs[1][-1] == (STEPS - 1, True)

    j0, j1 = _as_state_dict(jfinals[0]), _as_state_dict(jfinals[1])
    for k in j0:
        np.testing.assert_array_equal(j0[k], j1[k])
        np.testing.assert_array_equal(tfinals[0][k], tfinals[1][k])
    bound = LR * STEPS * 2 * 32 * s_max
    worst = max(float(np.abs(tfinals[0][k] - j0[k]).max()) for k in j0)
    assert worst <= bound, (worst, bound)


def test_crash_heal_slice_over_pg_matches_http():
    """The same slice healed over PGTransport, in place into the live
    model: the commit and discard sequences and the final parameters are
    the HTTP heal's, bit for bit, and every parameter keeps its storage
    through the heals."""
    inits = _init_trees()
    runs = {}
    ptrs = []
    for transport in ("http", "pg"):
        lh = _lighthouse(LighthouseServer)
        try:
            runs[transport] = _torch_slice(f"127.0.0.1:{lh.port}", inits, transport,
                                           ptrs if transport == "pg" else None)
        finally:
            lh.shutdown()
    (hfinals, hlogs), (pfinals, plogs) = runs["http"], runs["pg"]
    assert plogs == hlogs and (FAIL_AT, False) in plogs[0]
    for r in range(2):
        for k in hfinals[r]:
            np.testing.assert_array_equal(pfinals[r][k], hfinals[r][k])
    assert len(ptrs) == 2 and all(before == after for before, after in ptrs)


def _one_step(make_manager, lighthouse_cls, grads, to_leaves):
    lh = _lighthouse(lighthouse_cls)
    addr = f"127.0.0.1:{lh.port}"

    def replica(rid):
        manager = make_manager(rid, addr)
        try:
            manager.start_quorum()
            out = manager.allreduce(to_leaves(grads[rid]), should_quantize=True)
            out = out.get_future().wait(TIMEOUT)
            assert manager.should_commit()
            return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                    for k, v in out.items()}
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


@pytest.mark.parametrize("stream_buckets", [False, None], ids=["serial", "default"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_same_gradients_allreduce_bitwise(engine, stream_buckets):
    """Identical gradients into both packages' Manager.allreduce: bitwise
    equal results (device engine: JAX arrays vs torch tensors; host
    engine: numpy in both), on the serial path (``stream_buckets=False``)
    and at the default (streamed fp8 buckets with error feedback).
    init_sync is off so both replicas participate."""
    rng = np.random.RandomState(11)
    grads = [{"a": rng.randn(300, 7).astype(np.float32),
              "b": (rng.randn(1025) * 1e3).astype(np.float32)} for _ in range(2)]
    common = dict(min_replica_size=2, timeout=TIMEOUT, quorum_timeout=TIMEOUT, init_sync=False,
                  stream_buckets=stream_buckets)

    def jax_manager(rid, addr):
        return JaxManager(pg=JaxPGHost(timeout=TIMEOUT), load_state_dict=lambda sd: None,
                          state_dict=lambda: {}, replica_id=f"r{rid}", lighthouse_addr=addr,
                          **common)

    def torch_manager(rid, addr):
        return Manager(pg=ProcessGroupHost(timeout=TIMEOUT), load_state_dict=lambda sd: None,
                       state_dict=lambda: {}, replica_id=f"r{rid}", lighthouse_addr=addr,
                       **common)

    if engine == "device":
        jleaves = lambda g: {k: jnp.asarray(v) for k, v in g.items()}  # noqa: E731
        tleaves = lambda g: {k: torch.from_numpy(v) for k, v in g.items()}  # noqa: E731
    else:
        jleaves = tleaves = lambda g: {k: v.copy() for k, v in g.items()}  # noqa: E731
    jout = _one_step(jax_manager, JaxLighthouse, grads, jleaves)
    tout = _one_step(torch_manager, LighthouseServer, grads, tleaves)
    for r in range(2):
        for k in grads[0]:
            np.testing.assert_array_equal(tout[r][k].view(np.uint32), jout[r][k].view(np.uint32))


def test_state_serialization_round_trip():
    """Model and optimizer state (tensors of several dtypes, ints, floats,
    tuples, None) survive flatten/unflatten; a template lands tensor
    leaves on its devices."""
    model = tl.Llama(tl.CONFIGS["debug"], device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    optim = torch.optim.AdamW(model.parameters())
    model.loss(torch.zeros(1, 4, dtype=torch.long), torch.ones(1, 4, dtype=torch.long)).backward()
    optim.step()
    state = {"model": model.state_dict(), "optim": optim.state_dict(),
             "extra": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    spec, payloads = flatten_state(state)
    wire = [bytearray(p.tobytes()) if hasattr(p, "tobytes") else p for p in payloads]
    back = unflatten_state(spec, wire, template=state)
    assert torch.equal(back["extra"], state["extra"])
    for k, v in state["model"].items():
        assert torch.equal(back["model"][k], v)
    assert back["optim"]["param_groups"] == state["optim"]["param_groups"]
    for pid, s in state["optim"]["state"].items():
        for name, t in s.items():
            assert torch.equal(back["optim"]["state"][pid][name], t)


def test_http_transport_round_trip():
    state = {"w": torch.randn(1000, 37), "h": torch.arange(10, dtype=torch.bfloat16),
             "step": 3}
    sender, receiver = HTTPTransport(timeout=10), HTTPTransport(timeout=10)
    try:
        sender.send_checkpoint([1], step=7, state_dict=state, timeout=10)
        got = receiver.recv_checkpoint(0, sender.metadata(), step=7, timeout=10)
        sender.disallow_checkpoint()
    finally:
        sender.shutdown()
        receiver.shutdown()
    assert got["step"] == 3
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["h"], state["h"])


def test_lighthouse_client_sees_heartbeats():
    from torchft_tpu_torch.coordination import LighthouseClient

    lh = _lighthouse(LighthouseServer)
    try:
        client = LighthouseClient(f"127.0.0.1:{lh.port}")
        client.heartbeat("replica_x")
        assert "quorum_id" in client.status()
    finally:
        lh.shutdown()


def test_dummy_process_group_passes_through():
    from torchft_tpu_torch.collectives import allreduce_quantized
    from torchft_tpu_torch.process_group import ProcessGroupDummy, ReduceOp

    x = [torch.randn(5, 3), torch.randn(7)]
    out = allreduce_quantized(x, ReduceOp.SUM, ProcessGroupDummy()).get_future().wait(10)
    assert all(torch.equal(a, b) for a, b in zip(out, x))


# -- the synchronous quorum (use_async_quorum=False) against the reference ------

def _quorum_script(make_manager, lighthouse_cls, to_leaf, to_np, use_async_quorum,
                   transport_cls=None):
    """Two replicas take a step together (the first quorum's init_sync heal
    makes them equal); then replica 1 restarts, a fresh Manager at step 0
    with fresh state (and ``transport_cls`` for its heal), and both take a
    second step. Returns what each saw in the second step: after
    start_quorum (before its forward pass), in the allreduce and at the
    vote."""
    lh = _lighthouse(lighthouse_cls)
    addr = f"127.0.0.1:{lh.port}"

    def one_step(manager, rid, state):
        manager.start_quorum()
        rec = {"healed_before_forward": manager.last_quorum_healed(),
               "w_before_forward": to_np(state["w"]).tolist()}
        out = manager.allreduce({"g": to_leaf(np.full(2, rid + 1.0, np.float32))})
        rec["avg"] = to_np(out.get_future().wait(TIMEOUT)["g"]).tolist()
        rec["participants"] = manager.num_participants()
        rec["participating"] = manager.is_participating()
        rec["commit"] = manager.should_commit()
        rec["healed"] = manager.last_quorum_healed()
        rec["w_after_commit"] = to_np(state["w"]).tolist()
        rec["step"] = manager.current_step()
        return rec

    def incarnation(rid, transport=None):
        state = {"w": to_leaf(np.full(3, float(rid), np.float32))}

        def load(sd):
            state["w"] = to_leaf(np.asarray(to_np(sd["w"])))

        return make_manager(rid, addr, load, lambda: {"w": state["w"]}, use_async_quorum,
                            transport), state

    def replica(rid):
        manager, state = incarnation(rid)
        try:
            one_step(manager, rid, state)
            if rid == 1:
                manager.shutdown(wait=False)
                manager, state = incarnation(
                    rid, transport_cls(timeout=TIMEOUT) if transport_cls else None)
            return one_step(manager, rid, state)
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return [f.result(timeout=120) for f in [ex.submit(replica, r) for r in range(2)]]
    finally:
        lh.shutdown()


def _jax_quorum_manager(rid, addr, load, save, use_async_quorum, transport):
    return JaxManager(pg=JaxPGHost(timeout=TIMEOUT), load_state_dict=load, state_dict=save,
                      min_replica_size=1, use_async_quorum=use_async_quorum,
                      replica_id=f"r{rid}", lighthouse_addr=addr, timeout=TIMEOUT,
                      quorum_timeout=TIMEOUT, checkpoint_transport=transport)


def _torch_quorum_manager(rid, addr, load, save, use_async_quorum, transport):
    return Manager(pg=ProcessGroupHost(timeout=TIMEOUT), load_state_dict=load, state_dict=save,
                   min_replica_size=1, use_async_quorum=use_async_quorum,
                   replica_id=f"r{rid}", lighthouse_addr=addr, timeout=TIMEOUT,
                   quorum_timeout=TIMEOUT, checkpoint_transport=transport)


def _both_quorum_scripts(use_async_quorum, failing_recv=False):
    from torchft_tpu.checkpointing import HTTPTransport as JaxHTTPTransport

    def failing(cls):
        class FailingRecv(cls):
            def recv_checkpoint(self, *a, **k):
                raise RuntimeError("injected recovery failure")

            recv_checkpoint_multi = recv_checkpoint

        return FailingRecv

    jax_records = _quorum_script(
        _jax_quorum_manager, JaxLighthouse, lambda a: jnp.asarray(a), np.asarray,
        use_async_quorum, failing(JaxHTTPTransport) if failing_recv else None)
    torch_records = _quorum_script(
        _torch_quorum_manager, LighthouseServer, torch.from_numpy, lambda t: t.numpy(),
        use_async_quorum, failing(HTTPTransport) if failing_recv else None)
    assert torch_records == jax_records, (torch_records, jax_records)
    return torch_records


def test_sync_quorum_heals_inside_start_quorum_as_the_reference():
    """The restarted replica's heal lands in start_quorum:
    last_quorum_healed() is true and its state is the peer's before the
    forward pass, and it takes part in the step (2 participants, its own
    gradient averaged in)."""
    survivor, healed = _both_quorum_scripts(use_async_quorum=False)
    assert healed["healed_before_forward"] and healed["w_before_forward"] == [0.0] * 3
    assert not survivor["healed_before_forward"]
    for r in (survivor, healed):
        assert r["participants"] == 2 and r["participating"]
        assert r["avg"] == [1.5, 1.5] and r["commit"] and r["step"] == 2


def test_async_quorum_heals_at_the_vote_as_the_reference():
    """Under the async quorum the restarted replica sits the step out: 1
    participant, its contribution zeros, the heal applied at the vote."""
    survivor, healed = _both_quorum_scripts(use_async_quorum=True)
    assert not healed["healed_before_forward"] and healed["w_before_forward"] == [1.0] * 3
    assert healed["healed"] and not healed["participating"]
    assert healed["w_after_commit"] == [0.0] * 3 and survivor["participating"]
    for r in (survivor, healed):
        assert r["participants"] == 1 and r["avg"] == [1.0, 1.0] and r["commit"]


def test_sync_quorum_failed_recovery_votes_false_as_the_reference():
    """A failed recovery leaves no healing state behind and the step's
    vote fails (the survivor's too: the replica that failed to heal never
    joined the allreduce)."""
    survivor, failed = _both_quorum_scripts(use_async_quorum=False, failing_recv=True)
    assert not failed["commit"] and not failed["healed"] and failed["participating"]
    assert failed["step"] == 0 and failed["w_before_forward"] == [1.0] * 3
    assert not survivor["commit"] and survivor["step"] == 1


@pytest.mark.parametrize("use_async_quorum", [True, False], ids=["async", "sync"])
def test_is_participating_follows_the_quorum_mode(use_async_quorum):
    """A healing replica does not participate under the async quorum; the
    sync quorum never leaves one healing (the reference asserts it)."""
    m = Manager.__new__(Manager)
    m._participating_replica_rank = 0
    m._use_async_quorum = use_async_quorum
    m._healing = False
    assert m.is_participating()
    m._healing = True
    if use_async_quorum:
        assert not m.is_participating()
    else:
        with pytest.raises(AssertionError):
            m.is_participating()
    m._participating_replica_rank = None
    assert not m.is_participating()


def test_diloco_on_an_async_quorum_manager_raises_as_the_reference():
    import optax

    from torchft_tpu.local_sgd import DiLoCo as JaxDiLoCo
    from torchft_tpu_torch.local_sgd import DiLoCo

    lh = _lighthouse(LighthouseServer)
    jlh = _lighthouse(JaxLighthouse)
    managers = [
        _torch_quorum_manager(0, f"127.0.0.1:{lh.port}", lambda sd: None, lambda: {}, True, None),
        _jax_quorum_manager(0, f"127.0.0.1:{jlh.port}", lambda sd: None, lambda: {}, True, None),
    ]
    try:
        with pytest.raises(ValueError, match="synchronous quorum"):
            DiLoCo(managers[0], {"w": torch.zeros(2)}, lambda ps: torch.optim.SGD(ps, lr=1.0),
                   sync_every=2)
        with pytest.raises(ValueError, match="synchronous quorum"):
            JaxDiLoCo(managers[1], {"w": np.zeros(2)}, optax.sgd(1.0), sync_every=2)
    finally:
        for m in managers:
            m.shutdown(wait=False)
        lh.shutdown()
        jlh.shutdown()
