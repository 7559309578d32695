"""A crash after the backward pass among three replicas, on both packages.

Three replica groups (threads) train the debug Llama against a lighthouse
that wants all three; replica 1 crashes after step 2's backward pass (the
step's quorum is in: ``--fail-at``'s point) and restarts, healing over HTTP.
The survivors' ring allreduce of step 2 then fails and the step is
discarded. With three replicas one survivor sees the dead socket at once,
while the other's ring receive waits on the survivor that failed first,
whose connection stays open: it waits out its process group's timeout.

The reference runs the script first (its ``Manager``, ``ProcessGroupHost``
and ``HTTPTransport`` as replica threads, gradients by ``jax.grad`` of
``llama_loss``), then the port's trainer (``train.run_replicas``) with the
same timeout. Both discard step 2 on both survivors, one survivor's
discarded step lasting the timeout and the other's not, and both end with
equal replicas: the stall is the reference's design, and the timeout
bounds it.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torchft_tpu import coordination as ref_coord
from torchft_tpu.checkpointing import HTTPTransport as RefHTTP
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu.models import llama as jl
from torchft_tpu.process_group import ProcessGroupHost as RefPG

# the process group's (and every other) timeout of both runs, seconds
TIMEOUT_S = 5.0
STEPS, CRASH_STEP, REPLICAS = 4, 2, 3


class _Crash(Exception):
    pass


def _reference_run():
    """The script on the reference: each replica's (step, committed,
    step_ms) votes and final parameters."""
    cfg = jl.CONFIGS["debug"]
    grad_fn = jax.jit(jax.value_and_grad(lambda p, t, y: jl.llama_loss(p, t, y, cfg)))
    fired = []

    def replica(rid: int, addr: str):
        votes = []
        while True:
            params = {"p": jax.tree_util.tree_map(
                np.asarray, jl.llama_init(jax.random.PRNGKey(rid), cfg))}

            def load(sd, params=params):
                params["p"] = jax.tree_util.tree_map(np.array, sd["p"])

            manager = RefManager(
                pg=RefPG(timeout=TIMEOUT_S), load_state_dict=load,
                state_dict=lambda params=params: {"p": params["p"]}, min_replica_size=1,
                replica_id=f"replica_{rid}", lighthouse_addr=addr, timeout=TIMEOUT_S,
                quorum_timeout=TIMEOUT_S, checkpoint_transport=RefHTTP(timeout=TIMEOUT_S))
            try:
                while manager.current_step() < STEPS:
                    step = manager.current_step()
                    t0 = time.perf_counter()
                    manager.start_quorum()
                    toks = np.random.RandomState(7919 * (step + 1) + rid).randint(
                        0, cfg.vocab_size, (1, 17)).astype(np.int32)
                    _, grads = grad_fn(params["p"], jnp.asarray(toks[:, :-1]),
                                       jnp.asarray(toks[:, 1:]))
                    grads = jax.tree_util.tree_map(np.asarray, grads)
                    if (rid, step) == (1, CRASH_STEP) and not fired:
                        fired.append(rid)
                        raise _Crash()
                    avg = manager.allreduce(grads).get_future().wait()
                    committed = manager.should_commit()
                    if committed:
                        params["p"] = jax.tree_util.tree_map(lambda p, a: p - 0.01 * a,
                                                             params["p"], avg)
                    votes.append((step, committed, (time.perf_counter() - t0) * 1e3))
                return votes, jax.tree_util.tree_leaves(params["p"])
            except _Crash:
                continue
            finally:
                manager.shutdown(wait=False)

    lighthouse = ref_coord.LighthouseServer(
        bind="127.0.0.1:0", min_replicas=REPLICAS, join_timeout_ms=1000, quorum_tick_ms=20,
        heartbeat_timeout_ms=2000)
    try:
        with ThreadPoolExecutor(REPLICAS) as ex:
            futs = [ex.submit(replica, i, f"127.0.0.1:{lighthouse.port}")
                    for i in range(REPLICAS)]
            out = [f.result(timeout=120) for f in futs]
    finally:
        lighthouse.shutdown()
    assert fired == [1]
    for _, leaves in out[1:]:
        for a, b in zip(leaves, out[0][1]):
            np.testing.assert_array_equal(a, b)
    return [votes for votes, _ in out]


def _port_run(monkeypatch):
    from torchft_tpu_torch import train
    from torchft_tpu_torch.train import Fault

    monkeypatch.setattr(train, "TIMEOUT_S", TIMEOUT_S)
    cfg = train.TrainConfig(config="debug", steps=STEPS, seq_len=16, quantize=False,
                            replicas=REPLICAS, transport="http",
                            faults=(Fault(1, CRASH_STEP, "crash", at="backward"),))
    results = train.run_replicas(cfg, "cpu")
    assert results[1]["restarts"] == 1
    for r in results[1:]:
        for k, v in results[0]["params"].items():
            assert torch.equal(v, r["params"][k]), k
    return [[(e["step"], e["committed"], e["step_ms"]) for e in r["log"]] for r in results]


def _discarded_ms(votes):
    """Each survivor's discarded step's ms (replicas 0 and 2)."""
    out = []
    for rid in (0, 2):
        ms = [t for step, committed, t in votes[rid] if step == CRASH_STEP and not committed]
        assert len(ms) == 1, (rid, votes[rid])
        out.append(ms[0])
    return out


def test_a_crash_after_backward_stalls_one_survivor_for_the_pg_timeout_in_both(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {"reference": _reference_run(), "port": _port_run(monkeypatch)}
    finally:
        torch.set_num_threads(n)
    bound_ms = TIMEOUT_S * 1e3
    for name, votes in runs.items():
        for rid in (0, 2):
            assert [s for s, c, _ in votes[rid] if c] == list(range(STEPS)), (name, rid)
        stalls = sorted(_discarded_ms(votes))
        # one survivor saw the dead socket at once; the other waited out
        # the timeout, and no longer than it (plus the step's own work)
        assert stalls[0] < 0.5 * bound_ms, (name, stalls)
        assert 0.9 * bound_ms <= stalls[1] <= bound_ms + 3e3, (name, stalls)
