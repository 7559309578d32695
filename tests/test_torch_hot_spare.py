"""A crash healed by parallel reconstruct and a permanent death covered by a
hot spare, in the reference and in the port: the fast counterpart of the
reference's slow soak ``tests/test_chaos_soak.py::
test_hot_spare_swap_in_under_load_converges_bitwise`` (``:868``).

Three members train with the redundancy plane on (k 2, m 1, retain 1, a
generation staged every commit) beside one hot spare, against a lighthouse
that wants all three in every quorum. Replica 2 crashes in step 3 once the
step's quorum is in (after its backward pass in the port), when the others
have staged that step's generation, and restarts: the survivors discard
the step, its own store died with it, so one holder of every other
owner's shards is gone and its heal must decode through the parity shard.
Replica 1 dies for good at the start of step 5, once the spare holds that
step's generation; the script posts the death to the directory
(``mark_dead``), which promotes the spare; the spare loads its prefetched
generation and joins. The bar, in both packages: the members left and the
promoted spare bitwise equal at the end, every one at the last step, no
committed step lost (within an incarnation a step commits once, and the
fleet's committed frontier never moves back), the rejoin healed by
reconstruct with no failure, and the spare promoted in replica 1's place.
In the port also: step 3 discarded by the survivors, and the spare joined
at the step of its prefetched generation with no peer pull.

The reference runs first, its Manager over numpy parameters (the soak's
loop); then the port's trainer (``train.run_replicas``) on the debug
Llama, with its timeouts cut to ``TIMEOUT``: one survivor's ring receive
waits out its process group's timeout after the crash
(``tests/test_torch_three_replica_crash.py``), in both packages.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu import redundancy as ref_redundancy
from torchft_tpu.checkpointing import HTTPTransport as RefHTTPTransport
from torchft_tpu.coordination import LighthouseServer as RefLighthouse
from torchft_tpu.manager import Manager as RefManager
from torchft_tpu.process_group import ProcessGroupHost as RefPG
from torchft_tpu_torch import train
from torchft_tpu_torch.train import DEAD_AFTER_S, Fault, TrainConfig, run_replicas

MEMBERS = 3
STEPS = 8
CRASH = (2, 3)  # (replica, step): crashes once the step's quorum is in, restarts
DEATH = (1, 5)  # dies at the step's start, for good
TIMEOUT = 5.0
# the heal transport's timeout: a source that staged its state for a
# healer that reconstructed instead waits out its serving window's grace
# (min(timeout, 10 s)) at its next vote, in both packages
HTTP_TIMEOUT = 4.0


@pytest.fixture(autouse=True)
def _no_plane_env(monkeypatch):
    for env in ("TORCHFT_REDUNDANCY_K", "TORCHFT_REDUNDANCY_M", "TORCHFT_REDUNDANCY_DIRECTORY",
                "TORCHFT_REDUNDANCY_INTERVAL", "TORCHFT_REDUNDANCY_RETAIN",
                "TORCHFT_REDUNDANCY_TIMEOUT_S", "TORCHFT_POD"):
        monkeypatch.delenv(env, raising=False)


class _Crash(Exception):
    pass


class _Death(Exception):
    pass


def _reference_scenario(monkeypatch):
    """The reference's Managers (numpy parameters): returns final params per
    surviving replica, the rejoin's counters and the promotion."""
    directory = ref_redundancy.ShardDirectory(poll_s=0.05, dead_after_s=DEAD_AFTER_S)
    lh = RefLighthouse(bind="127.0.0.1:0", min_replicas=MEMBERS, join_timeout_ms=1000,
                       quorum_tick_ms=20, heartbeat_timeout_ms=800)
    directory._lighthouse_addr = lh.address()
    monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "2")
    monkeypatch.setenv("TORCHFT_REDUNDANCY_M", "1")
    monkeypatch.setenv("TORCHFT_REDUNDANCY_RETAIN", "1")
    monkeypatch.setenv("TORCHFT_REDUNDANCY_DIRECTORY", directory.url)
    live, spares = {}, []
    finals, committed, rejoin, promotion = {}, {}, {}, {}
    frontier = [-1]
    lock = threading.Lock()
    members_left = [MEMBERS]
    done = threading.Event()

    def wait_staged(rid, step, spare_too):
        # every other member's generation of the step announced; for a
        # death, also held by the spare
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            others = [m for j, m in list(live.items()) if j != rid]
            if all(m._shard_stager.last_staged_step() >= step for m in others) and (
                    not spare_too or spares[0]._hot_spare.prefetched_step() >= step):
                return
            time.sleep(0.01)

    def make(rid, params, spare=False):
        def load(sd):
            params["w"] = np.array(np.asarray(sd["w"]), dtype=np.float32)

        return RefManager(
            pg=RefPG(timeout=TIMEOUT), load_state_dict=load,
            state_dict=lambda: {"w": params["w"].copy()}, min_replica_size=1,
            use_async_quorum=True, replica_id=f"replica_{rid}",
            lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=TIMEOUT, quorum_timeout=TIMEOUT,
            heartbeat_interval=0.02, spare=spare,
            checkpoint_transport=RefHTTPTransport(timeout=HTTP_TIMEOUT),
        )

    def loop(rid, manager, params, incarnation):
        base = np.random.RandomState(800 + rid).randn(8).astype(np.float32)
        live[rid] = manager
        steps = committed.setdefault(rid, [])
        steps.append([])
        while manager.current_step() < STEPS:
            step = manager.current_step()
            if (rid, step) == DEATH:
                wait_staged(rid, step, spare_too=True)
                raise _Death()
            manager.start_quorum()
            if (rid, step) == CRASH and incarnation == 0:
                # the quorum is in: the survivors' allreduce of this step fails
                manager.wait_quorum()
                wait_staged(rid, step, spare_too=False)
                raise _Crash()
            grad = (base * (1.0 + 0.01 * step)).astype(np.float32)
            avg = manager.allreduce({"w": grad}).get_future().wait(TIMEOUT)
            if manager.should_commit():
                steps[-1].append(manager.current_step() - 1)
                with lock:
                    assert manager.current_step() - 1 >= frontier[0] - 1
                    frontier[0] = max(frontier[0], manager.current_step() - 1)
                params["w"] = (params["w"] - 0.1 * np.asarray(avg["w"])).astype(np.float32)
        finals[rid] = params["w"].copy()

    def member(rid):
        incarnation = 0
        try:
            while True:
                params = {"w": np.random.RandomState(rid + incarnation * 10).randn(8)
                          .astype(np.float32)}
                manager = make(rid, params)
                try:
                    loop(rid, manager, params, incarnation)
                    t = manager.timings()
                    rejoin[rid] = (t.get("reconstructs", 0.0), t.get("reconstruct_failures", 0.0),
                                   incarnation)
                    return
                except _Crash:
                    incarnation += 1
                except _Death:
                    rid_full = manager._replica_id
                    directory.mark_dead(rid_full)
                    return
                finally:
                    live.pop(rid, None)
                    manager.shutdown(wait=False)
        finally:
            with lock:
                members_left[0] -= 1
                if members_left[0] == 0:
                    done.set()

    def spare():
        params = {"w": np.zeros(8, np.float32)}
        manager = make(MEMBERS, params, spare=True)
        spares.append(manager)
        try:
            while not done.is_set():
                try:
                    promotion.update(manager.promote(timeout=0.2))
                    break
                except TimeoutError:
                    continue
            if promotion:
                loop(MEMBERS, manager, params, incarnation=0)
        finally:
            live.pop(MEMBERS, None)
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(max_workers=MEMBERS + 1) as ex:
            futs = [ex.submit(member, r) for r in range(MEMBERS)] + [ex.submit(spare)]
            for f in futs:
                f.result(timeout=120)
    finally:
        lh.shutdown()
        directory.shutdown()
    return finals, committed, rejoin, promotion


def _assert_no_step_lost(committed):
    for rid, incarnations in committed.items():
        for steps in incarnations:
            assert steps == sorted(set(steps)), (rid, steps)


def test_crash_reconstruct_and_spare_promotion_in_both_packages(monkeypatch):
    finals, committed, rejoin, promotion = _reference_scenario(monkeypatch)
    # the reference's outcome
    assert set(finals) == {0, 2, MEMBERS}, finals.keys()
    for rid in (2, MEMBERS):
        np.testing.assert_array_equal(finals[0], finals[rid])
    _assert_no_step_lost(committed)
    assert rejoin[2] == (1.0, 0.0, 1)  # the restarted incarnation: one reconstruct
    assert promotion["replaces"].startswith("replica_1:")
    ref_frontier = max(s for incs in committed.values() for steps in incs for s in steps)
    assert ref_frontier == STEPS - 1

    # the port's trainer on the debug Llama, the same script
    for env in ("TORCHFT_REDUNDANCY_K", "TORCHFT_REDUNDANCY_M", "TORCHFT_REDUNDANCY_RETAIN",
                "TORCHFT_REDUNDANCY_DIRECTORY"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(train, "TIMEOUT_S", TIMEOUT)
    cfg = TrainConfig(config="debug", seq_len=16, steps=STEPS, replicas=MEMBERS,
                      redundancy=(2, 1), redundancy_retain=1, spares=1, http_timeout=HTTP_TIMEOUT,
                      faults=(Fault(CRASH[0], CRASH[1], "crash", at="backward"),
                              Fault(DEATH[0], DEATH[1], "die")))
    results = run_replicas(cfg, "cpu")
    died, spare = results[DEATH[0]], results[MEMBERS]
    assert died.get("died") and died["replica_id"].startswith("replica_1:")
    assert spare["promotion"]["replaces"] == died["replica_id"]
    alive = [results[0], results[2], spare]
    assert all(r["step"] == STEPS for r in alive)
    # the one error: replica 0's discarded step (the restarted replica's
    # incarnation and the spare joined after it)
    assert [r["metrics"]["errors"] for r in alive] == [1, 0, 0]
    for r in alive[1:]:
        for name, p in alive[0]["params"].items():
            assert torch.equal(p, r["params"][name]), name
    assert all(r["storage_kept"] for r in alive)
    rejoined = results[CRASH[0]]
    assert rejoined["restarts"] == 1
    assert rejoined["last_incarnation"]["reconstructs"] == 1
    assert rejoined["last_incarnation"]["reconstruct_failures"] == 0
    # no committed step lost: within an incarnation (a restart starts a new
    # one) each step commits once, and the frontier reaches the last step
    for r in results:
        steps = [e["step"] for e in r["log"] if e["committed"]]
        if r is not rejoined:
            assert steps == sorted(set(steps)), steps
    frontier = -1
    for e in sorted((e for r in results for e in r["log"] if e["committed"]),
                    key=lambda e: e["at"]):
        assert e["step"] >= frontier - 1, (e["replica"], e["step"], frontier)
        frontier = max(frontier, e["step"])
    assert frontier == ref_frontier == STEPS - 1
    # the crash discarded step 3 on both survivors
    for r in (results[0], results[DEATH[0]]):
        assert [e["committed"] for e in r["log"] if e["step"] == CRASH[1]][0] is False
    # the spare joined from its prefetched generation of the death's step,
    # with no heal (and so no peer pull)
    assert spare["redundancy"]["spare_promote_step"] == DEATH[1]
    assert spare["timings"]["heal_attempts"] == 0
    assert spare["redundancy"]["reconstruct_failures"] == 0


# -- the serve shadow ------------------------------------------------------------

def _spare_serve_versions(redundancy_mod, serving_mod, device_kw):
    """A hot spare shadowing a registry while one publisher publishes four
    versions (a quorum bump before the last): the spare's
    ``status()["serve_version"]`` after each, and the shadow's flat."""
    directory = redundancy_mod.ShardDirectory(poll_s=0.05)
    reg = serving_mod.SnapshotRegistry()
    cfg = serving_mod.ServeConfig(registry=reg.url, compress="fp8", poll_s=0.01, timeout_s=5.0)
    pub = serving_mod.SnapshotPublisher("serve_r0", config=cfg, registry_url=reg.url)
    spare = redundancy_mod.HotSpare(
        redundancy_mod.RedundancyConfig(k=1, m=1, directory=directory.url, timeout_s=5.0),
        spare_id="spare_0", poll_s=0.05, serve_registry=reg.url)
    seen = [spare.status()["serve_version"]]
    try:
        w = np.random.RandomState(21).randn(3000).astype(np.float32)
        for version in ((1, 0), (1, 1), (1, 2), (2, 3)):
            w = w * np.float32(0.97) + np.float32(0.05)
            assert pub.publish(*version, {"w": w}) == version
            deadline = time.monotonic() + 10.0
            while spare.status()["serve_version"] != list(version) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            seen.append(spare.status()["serve_version"])
        flat = spare._serve_worker.params_flat()
        return seen, np.asarray(flat.numpy() if isinstance(flat, torch.Tensor) else flat)
    finally:
        spare.shutdown()
        pub.shutdown()
        reg.shutdown()
        directory.shutdown()


def test_hot_spare_serve_shadow_follows_the_chain_as_the_reference():
    """``HotSpare(serve_registry=URL)`` shadows the serving plane's delta
    chain (the reference raised ``NotImplementedError`` in the port before):
    ``status()["serve_version"]`` follows every published version, as the
    reference's spare does on the same registry script, and the shadow's
    flat (on the host) equals the reference shadow's bit for bit."""
    from torchft_tpu import serving as ref_serving
    from torchft_tpu_torch import redundancy as port_redundancy
    from torchft_tpu_torch import serving as port_serving

    got, got_flat = _spare_serve_versions(port_redundancy, port_serving, {})
    want, want_flat = _spare_serve_versions(ref_redundancy, ref_serving, {})
    assert got == want == [None, [1, 0], [1, 1], [1, 2], [2, 3]]
    np.testing.assert_array_equal(got_flat, want_flat)


def test_manager_spare_shadows_the_registry_it_is_given(monkeypatch):
    """``Manager(spare=True)`` hands ``TORCHFT_SERVE_REGISTRY`` to its hot
    spare (reference ``manager.py:655-660``); the spare's shutdown joins
    its shadow worker."""
    from torchft_tpu_torch import serving as port_serving
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupDummy
    from torchft_tpu_torch.redundancy import ShardDirectory

    directory = ShardDirectory(poll_s=0.05)
    reg = port_serving.SnapshotRegistry()
    monkeypatch.setenv("TORCHFT_SERVE_REGISTRY", reg.url)
    monkeypatch.setenv("TORCHFT_REDUNDANCY_DIRECTORY", directory.url)
    monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "1")
    mgr = Manager(pg=ProcessGroupDummy(), load_state_dict=lambda sd: None,
                  state_dict=lambda: {"w": torch.zeros(2)}, min_replica_size=1,
                  replica_id="spare_mgr", lighthouse_addr="127.0.0.1:1", timeout=5.0,
                  spare=True)
    try:
        shadow = mgr._hot_spare._serve_worker
        assert shadow is not None and shadow.device.type == "cpu"
        assert mgr._hot_spare.status()["serve_version"] is None
    finally:
        mgr.shutdown()
        reg.shutdown()
        directory.shutdown()
    assert not shadow._pull_thread.is_alive()
