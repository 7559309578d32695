"""The port's redundancy plane (``torchft_tpu_torch/redundancy.py``) on the
cases of ``tests/test_redundancy.py``, and against the reference's:

* the config and its environment;
* the ShardDirectory's (epoch, seq, step) staleness matrix and spare
  promotion, and the same announce / mark_dead / health sequence fed to
  both packages' directories giving equal codes and promotion records
  (epochs and timestamps aside);
* placement, equal to the reference's over seeded random peer sets;
* the shard wire (ranged, resumable, crc32), across packages both ways;
* the parallel reconstruct of a torch state, bitwise, through a dead data
  holder and a corrupt shard, in place into a template;
* the Manager's k = 0 pin: with the plane off a heal never reconstructs
  and the directory is never contacted.

Blobs are not compared across packages: the pickled tree spec in a blob
describes torch leaves in one package and numpy leaves in the other. What
is held equal is the leaves' bytes, the shards of the same payload bytes
(``tests/test_torch_erasure.py``) and the directory's decisions.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu import healthwatch as ref_healthwatch
from torchft_tpu import observability as ref_observability
from torchft_tpu import redundancy as ref
from torchft_tpu_torch import healthwatch, observability
from torchft_tpu_torch import redundancy as port
from torchft_tpu_torch.checkpointing.erasure import encode_shards, shard_crc

OWN_URL = "http://127.0.0.1:1"  # placement tests never dial holders
ENVS = ("TORCHFT_REDUNDANCY_K", "TORCHFT_REDUNDANCY_M", "TORCHFT_REDUNDANCY_DIRECTORY",
        "TORCHFT_REDUNDANCY_INTERVAL", "TORCHFT_REDUNDANCY_TIMEOUT_S",
        "TORCHFT_REDUNDANCY_RETAIN", "TORCHFT_POD")


def _announce_body(owner, epoch, seq, step, k=2, m=1, data_len=12, urls=None):
    return {
        "replica_id": owner, "epoch": epoch, "seq": seq, "step": step, "k": k, "m": m,
        "data_len": data_len,
        "shards": [{"idx": i, "crc": 0, "url": (urls or [OWN_URL] * (k + m))[i],
                    "holder": f"h{i}"} for i in range(k + m)],
    }


@pytest.fixture(autouse=True)
def _no_plane_env(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)


@pytest.fixture()
def lockwatch():
    """The port's lock-order detector under every directory-backed test,
    as the reference's tests run under their own: locks created while the
    plane runs are instrumented, and an A->B / B->A acquisition inversion
    fails the test even if the deadlocking schedule never fires
    (``torchft_tpu_torch/analysis/lockgraph.py``)."""
    from torchft_tpu_torch.analysis import lockgraph

    with lockgraph.watch() as g:
        yield g
    lockgraph.assert_clean(g)


@pytest.fixture()
def directory(lockwatch):
    # a long dead_after_s: the announce-gap detector must not act in tests
    # that hold generations at different steps
    d = port.ShardDirectory(poll_s=0.05, dead_after_s=60.0)
    yield d
    d.shutdown()


def _threads_named(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


class TestRedundancyConfig:
    def test_default_env_is_off(self):
        cfg = port.RedundancyConfig.from_env()
        assert cfg.k == 0 and cfg.enabled is False
        assert cfg.to_json() == ref.RedundancyConfig.from_env().to_json()

    def test_enabled_needs_k_and_directory(self):
        assert port.RedundancyConfig(k=2, m=1).enabled is False
        assert port.RedundancyConfig(k=0, directory="http://d").enabled is False
        assert port.RedundancyConfig(k=2, m=1, directory="http://d").enabled

    @pytest.mark.parametrize("kwargs", [
        {"k": -1}, {"k": 2, "m": 0}, {"k": 200, "m": 56}, {"interval": 0},
        {"timeout_s": 0.0}, {"retain": 0},
    ])
    def test_invalid_configs_raise_as_the_reference(self, kwargs):
        for mod in (ref, port):
            with pytest.raises(ValueError):
                mod.RedundancyConfig(**kwargs).validate()

    def test_a_variable_set_wins_over_a_base_configs_field(self, monkeypatch):
        base = port.RedundancyConfig(k=2, m=1, directory="http://d", retain=1, interval=3)
        assert port.RedundancyConfig.from_env(base=base) == base
        monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "4")
        monkeypatch.setenv("TORCHFT_REDUNDANCY_INTERVAL", " ")  # blank: unset
        got = port.RedundancyConfig.from_env(base=base)
        assert (got.k, got.m, got.directory, got.retain, got.interval) == (4, 1, "http://d", 1, 3)
        assert port.RedundancyConfig.from_env(base=base, k=5).k == 5

    def test_bad_env_value_raises(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "two")
        with pytest.raises(ValueError, match="TORCHFT_REDUNDANCY_K"):
            port.RedundancyConfig.from_env()

    @pytest.mark.parametrize("env", [
        {"TORCHFT_REDUNDANCY_K": "2", "TORCHFT_REDUNDANCY_DIRECTORY": "http://d:1"},
        {"TORCHFT_REDUNDANCY_K": "8", "TORCHFT_REDUNDANCY_M": "2",
         "TORCHFT_REDUNDANCY_INTERVAL": "3", "TORCHFT_REDUNDANCY_TIMEOUT_S": "2.5",
         "TORCHFT_REDUNDANCY_RETAIN": "1", "TORCHFT_POD": "podB"},
    ])
    def test_env_reads_as_the_reference(self, monkeypatch, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert port.RedundancyConfig.from_env().to_json() == ref.RedundancyConfig.from_env().to_json()
        # a keyword given wins over its variable, in both
        assert (port.RedundancyConfig.from_env(directory="http://x").to_json()
                == ref.RedundancyConfig.from_env(directory="http://x").to_json())

    @pytest.mark.parametrize("env,want", [
        ({"TORCHFT_POD": "p7"}, "p7"),
        ({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "10.0.0.1:29511"}, None),
        ({}, "pod0"),
    ])
    def test_pod_identity_as_the_reference(self, monkeypatch, env, want):
        monkeypatch.delenv("TORCHFT_LIGHTHOUSE_AGGREGATOR", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert port.pod_identity() == ref.pod_identity()
        if want is not None:
            assert port.pod_identity() == want


class TestAnnounceStaleness:
    def test_fresh_announce_accepted(self, directory):
        _, resp = directory.register("own", "pod0", OWN_URL, False)
        code, resp = directory.announce(_announce_body("own", resp["epoch"], seq=1, step=1))
        assert code == 200, resp
        assert directory.directory()["entries"]["own"]["step"] == 1

    def test_stale_epoch_rejected(self, directory):
        directory.register("own", "pod0", OWN_URL, False)
        code, resp = directory.announce(_announce_body("own", "deadbeef0000", seq=1, step=1))
        assert code == 409 and resp["error"] == "stale_epoch"
        assert resp["epoch"] == directory.epoch
        assert "own" not in directory.directory()["entries"]

    def test_stale_seq_rejected(self, directory):
        _, resp = directory.register("own", "pod0", OWN_URL, False)
        epoch = resp["epoch"]
        assert directory.announce(_announce_body("own", epoch, seq=5, step=1))[0] == 200
        code, resp = directory.announce(_announce_body("own", epoch, seq=5, step=2))
        assert (code, resp["error"]) == (409, "stale_seq")
        code, resp = directory.announce(_announce_body("own", epoch, seq=4, step=2))
        assert (code, resp["error"]) == (409, "stale_seq")

    def test_stale_step_rejected(self, directory):
        _, resp = directory.register("own", "pod0", OWN_URL, False)
        epoch = resp["epoch"]
        assert directory.announce(_announce_body("own", epoch, seq=1, step=7))[0] == 200
        code, resp = directory.announce(_announce_body("own", epoch, seq=2, step=7))
        assert (code, resp["error"]) == (409, "stale_step")
        assert directory.directory()["entries"]["own"]["seq"] == 1

    def test_replaced_owner_cannot_resurrect(self, directory):
        _, resp = directory.register("own", "pod0", OWN_URL, False)
        epoch = resp["epoch"]
        directory.register("spare", "pod0", "", True)
        directory.announce(_announce_body("own", epoch, seq=1, step=1))
        directory.mark_dead("own")
        assert directory.spare_status("spare")["promote"] is True
        code, resp = directory.announce(_announce_body("own", epoch, seq=2, step=2))
        assert (code, resp["error"]) == (409, "stale_owner")

    def test_malformed_announce_is_400(self, directory):
        code, resp = directory.announce({"replica_id": "own"})
        assert code == 400 and "malformed" in resp["error"]

    def test_http_surface_matches(self, directory):
        client = port.DirectoryClient(directory.url, timeout=5.0)
        epoch = client.register("own", "pod0", OWN_URL)
        assert client.announce(_announce_body("own", epoch, seq=1, step=1))[0] == 200
        code, resp = client.announce(_announce_body("own", "deadbeef0000", seq=2, step=2))
        assert (code, resp["error"]) == (409, "stale_epoch")
        assert client.get_directory()["latest"] == ["own", 1]
        # the reference's client speaks to the port's directory, and back
        assert ref.DirectoryClient(directory.url, timeout=5.0).get_directory()["latest"] == ["own", 1]

    def test_register_revives_dead_replica(self, directory):
        directory.register("own", "pod0", OWN_URL, False)
        directory.mark_dead("own")
        assert "own" in directory.directory()["dead"]
        directory.register("own", "pod0", OWN_URL, False)
        assert "own" not in directory.directory()["dead"]

    def test_metrics_render(self, directory):
        _, resp = directory.register("own", "pod0", OWN_URL, False)
        directory.register("sp", "pod0", "", True)
        directory.announce(_announce_body("own", resp["epoch"], seq=1, step=4))
        with urllib.request.urlopen(f"{directory.url}/metrics", timeout=5) as r:
            text = r.read().decode()
        assert "redundancy_latest_step 4.0" in text and "redundancy_spares 1.0" in text
        assert "# TYPE redundancy_announce_total counter" in text


def _decision_script(d):
    """One sequence of registrations, announces, deaths and health dumps;
    the directory's answers and its final decisions, epochs and times
    aside."""
    out = []
    epoch = d.register("a", "pod0", OWN_URL, False)[1]["epoch"]
    d.register("b", "pod0", OWN_URL, False)
    d.register("c", "podB", OWN_URL, False)
    d.register("sp1", "pod0", "", True)
    d.register("sp2", "pod0", "", True)
    for body in (
        _announce_body("a", epoch, seq=1, step=1),
        _announce_body("a", epoch, seq=1, step=2),   # stale seq
        _announce_body("a", epoch, seq=2, step=1),   # stale step
        _announce_body("a", "000000000000", seq=3, step=3),  # stale epoch
        _announce_body("b", epoch, seq=1, step=2),
        _announce_body("c", epoch, seq=1, step=3),
        {"replica_id": "b"},  # malformed
    ):
        code, resp = d.announce(body)
        out.append((code, resp.get("error"), resp.get("have_seq"), resp.get("have_step")))
    d.apply_health({"replicas": {"sp1": {"state": "warn"}}, "excluded": []})
    out.append(d.mark_dead("a")[0])
    d.apply_health({"replicas": {"sp1": {"state": "ok"}}, "excluded": ["b"]})
    d._maybe_promote()
    out.append(d.announce(_announce_body("a", epoch, seq=9, step=9))[1].get("error"))
    d.mark_dead("a")  # a duplicate death never promotes twice
    state = d.directory()
    promos = {s: {k: v for k, v in p.items() if k != "at"} for s, p in state["promotions"].items()}
    entries = {o: (e["seq"], e["step"], e["k"], e["m"], e["data_len"])
               for o, e in state["entries"].items()}
    status = d.status()
    return out, promos, entries, state["latest"], state["dead"], status["counters"], \
        status["spares"], d.spare_status("sp2")["promote"]


def test_directory_decisions_are_the_references():
    dirs = [mod.ShardDirectory(poll_s=0.05, dead_after_s=60.0) for mod in (ref, port)]
    try:
        got_ref, got_port = (_decision_script(d) for d in dirs)
    finally:
        for d in dirs:
            d.shutdown()
    assert got_port == got_ref
    assert got_port[1]["sp1"]["replaces"] == "b" and got_port[1]["sp2"]["replaces"] == "a"


def test_gap_detector_presumes_a_quiet_owner_dead_as_the_reference():
    results = []
    for mod in (ref, port):
        d = mod.ShardDirectory(poll_s=0.02, dead_after_s=0.05, gap_steps=2)
        try:
            epoch = d.register("a", "pod0", OWN_URL, False)[1]["epoch"]
            d.register("b", "pod0", OWN_URL, False)
            d.register("sp", "pod0", "", True)
            d.announce(_announce_body("a", epoch, seq=1, step=1))
            d.announce(_announce_body("b", epoch, seq=1, step=3))
            deadline = time.monotonic() + 10
            while not d.spare_status("sp")["promote"] and time.monotonic() < deadline:
                time.sleep(0.01)
            st = d.status()
            results.append((st["dead"], {s: p["replaces"] for s, p in st["promotions"].items()}))
        finally:
            d.shutdown()
    assert results[0] == results[1] == (["a"], {"sp": "a"})


class TestIncarnations:
    """A Manager's id is ``<group>:<incarnation>``: a group's restart
    registers a new incarnation, which retires the old one (a port
    deviation: the reference keeps it, and placement and reconstruct keep
    dialling its dead store)."""

    def test_a_new_incarnation_retires_the_old_one_without_a_promotion(self, directory):
        epoch = directory.register("g:1", "pod0", OWN_URL, False)[1]["epoch"]
        directory.register("o:1", "pod0", OWN_URL, False)
        directory.register("sp:1", "pod0", "", True)
        assert directory.announce(_announce_body("g:1", epoch, seq=1, step=1))[0] == 200
        assert directory.announce(_announce_body("o:1", epoch, seq=1, step=2))[0] == 200
        directory.register("g:2", "pod0", OWN_URL, False)
        state = directory.directory()
        assert state["retired"] == ["g:1"] and state["dead"] == []
        assert [p["replica_id"] for p in directory.peers()["peers"]] == ["g:2", "o:1", "sp:1"]
        assert set(state["entries"]) == {"o:1"} and state["latest"] == ["o:1", 2]
        code, resp = directory.announce(_announce_body("g:1", epoch, seq=2, step=3))
        assert (code, resp["error"]) == (409, "stale_owner")
        directory._maybe_promote()
        assert not directory.spare_status("sp:1")["promote"]
        # the new incarnation announces from its own seq
        assert directory.announce(_announce_body("g:2", epoch, seq=1, step=3))[0] == 200

    def test_spares_and_ids_without_an_incarnation_retire_nothing(self, directory):
        for rid, spare in (("spare:1", True), ("spare:2", True), ("plain", False),
                           ("plain", False), ("spare:3", False)):
            directory.register(rid, "pod0", OWN_URL if not spare else "", spare)
        assert directory.directory()["retired"] == []
        assert [p["replica_id"] for p in directory.peers()["peers"]] == [
            "plain", "spare:1", "spare:2", "spare:3"]

    def test_placement_leaves_out_the_dead(self, directory):
        for rid in ("a:1", "b:1", "c:1"):
            directory.register(rid, "pod0", OWN_URL, False)
        directory.mark_dead("b:1")
        peers = directory.peers()["peers"]
        assert [p["replica_id"] for p in peers] == ["a:1", "c:1"]
        plan = port.plan_placement(peers, "a:1", "pod0", 2, 1)
        assert {p["replica_id"] for p in plan} == {"c:1"}
        directory.register("b:1", "pod0", OWN_URL, False)  # alive again
        assert len(directory.peers()["peers"]) == 3


class TestSparePromotion:
    def test_promote_seq_is_monotonic_and_single_use(self, directory):
        for rid in ("own_a", "own_b"):
            directory.register(rid, "pod0", OWN_URL, False)
        directory.register("sp1", "pod0", "", True)
        directory.register("sp2", "pod0", "", True)
        directory.mark_dead("own_a")
        promos = directory.directory()["promotions"]
        assert set(promos) == {"sp1"} and promos["sp1"]["replaces"] == "own_a"
        first_seq = promos["sp1"]["promote_seq"]
        directory.mark_dead("own_a")
        assert set(directory.directory()["promotions"]) == {"sp1"}
        directory.mark_dead("own_b")
        promos = directory.directory()["promotions"]
        assert promos["sp2"]["replaces"] == "own_b"
        assert promos["sp2"]["promote_seq"] > first_seq

    def test_spare_is_never_unpromoted(self, directory):
        directory.register("own_a", "pod0", OWN_URL, False)
        directory.register("sp1", "pod0", "", True)
        directory.mark_dead("own_a")
        directory.register("sp1", "pod0", "", True)
        status = directory.spare_status("sp1")
        assert status["promote"] is True and status["promotion"]["replaces"] == "own_a"

    def test_dead_spare_is_skipped(self, directory):
        directory.register("own_a", "pod0", OWN_URL, False)
        directory.register("sp1", "pod0", "", True)
        directory.register("sp2", "pod0", "", True)
        directory.mark_dead("sp1")
        directory.mark_dead("own_a")
        assert set(directory.directory()["promotions"]) == {"sp2"}

    def test_sick_spare_waits_for_clean_health(self, directory):
        directory.register("own_a", "pod0", OWN_URL, False)
        directory.register("sp1", "pod0", "", True)
        directory.apply_health({"replicas": {"sp1": {"state": "warn"}}, "excluded": []})
        directory.mark_dead("own_a")
        assert directory.directory()["promotions"] == {}
        directory.apply_health({"replicas": {"sp1": {"state": "ok"}}, "excluded": []})
        directory._maybe_promote()
        assert directory.spare_status("sp1")["promote"] is True

    def test_excluded_replica_counts_as_dead(self, directory):
        directory.register("own_a", "pod0", OWN_URL, False)
        directory.register("sp1", "pod0", "", True)
        directory.apply_health({"replicas": {}, "excluded": ["own_a"]})
        assert "own_a" in directory.directory()["dead"]
        assert directory.spare_status("sp1")["promote"] is True

    @pytest.mark.parametrize("state", ["ok", "OK ", "warn", "ejected", "probation", "degraded",
                                       "bogus", 0, 1, 2, 3, 4, 9, None])
    def test_spare_eligible_is_the_references(self, state):
        assert healthwatch.spare_eligible(state) == ref_healthwatch.spare_eligible(state)


class TestPlacement:
    @staticmethod
    def _peer(rid, pod, spare=False, url="http://h"):
        return {"replica_id": rid, "pod": pod, "spare": spare, "store_url": url}

    def test_data_in_pod_parity_out_of_pod(self):
        peers = [self._peer("own", "podA"), self._peer("d1", "podA"), self._peer("d2", "podA"),
                 self._peer("p1", "podB"), self._peer("p2", "podC"),
                 self._peer("sp", "podA", spare=True)]
        plan = port.plan_placement(peers, "own", "podA", k=2, m=2)
        assert [p["replica_id"] for p in plan[:2]] == ["d1", "d2"]
        assert [p["replica_id"] for p in plan[2:]] == ["p1", "p2"]

    def test_owner_and_spares_never_hold_shards(self):
        peers = [self._peer("own", "podA"), self._peer("sp", "podA", spare=True),
                 self._peer("d1", "podB")]
        plan = port.plan_placement(peers, "own", "podA", k=2, m=1)
        assert {p["replica_id"] for p in plan} == {"d1"}

    def test_no_eligible_holders_is_none(self):
        peers = [self._peer("own", "podA"), self._peer("sp", "podA", spare=True),
                 self._peer("nourl", "podA", url="")]
        assert port.plan_placement(peers, "own", "podA", k=2, m=1) is None

    @pytest.mark.parametrize("seed", range(12))
    def test_plan_is_the_references_over_random_peer_sets(self, seed):
        rng = np.random.RandomState(seed)
        peers = [self._peer(f"r{i}", f"pod{rng.randint(3)}", spare=bool(rng.rand() < 0.2),
                            url="" if rng.rand() < 0.1 else f"http://h{i}")
                 for i in range(rng.randint(1, 9))]
        own = peers[rng.randint(len(peers))]
        k, m = int(rng.randint(1, 6)), int(rng.randint(1, 4))
        assert (port.plan_placement(peers, own["replica_id"], own["pod"], k, m)
                == ref.plan_placement(peers, own["replica_id"], own["pod"], k, m))


class TestShardWire:
    @pytest.fixture(params=["port", "ref"])
    def stores(self, request):
        """(a store of one package, the getter of the other or the same)."""
        mod = port if request.param == "port" else ref
        s = mod.ShardStore("holder0")
        yield s, mod
        s.shutdown()

    @pytest.mark.parametrize("getter", [port, ref], ids=["port_get", "ref_get"])
    def test_roundtrip_and_crc_across_packages(self, stores, getter):
        store, _ = stores
        body = np.random.RandomState(0).bytes(100_000)
        store.put("own", 3, 0, body)
        got = getter.get_shard(store.url, "own", 3, 0, len(body), shard_crc(body), timeout=5.0)
        assert got == body
        with pytest.raises(IOError, match="crc32"):
            getter.get_shard(store.url, "own", 3, 0, len(body), shard_crc(body) ^ 1, timeout=5.0)

    @pytest.mark.parametrize("getter", [port, ref], ids=["port_get", "ref_get"])
    def test_torn_pull_resumes_from_offset_across_packages(self, stores, getter):
        store, store_mod = stores
        body = np.random.RandomState(1).bytes(200_000)
        store.put("own", 3, 0, body)
        fired = []

        def die_once(event, info):
            if event == "shard_get" and not fired:
                fired.append(info)
                return "die"  # half the body, then the socket drops
            return None

        store_mod.set_redundancy_fault_hook(die_once)
        try:
            got = getter.get_shard(store.url, "own", 3, 0, len(body), shard_crc(body), timeout=5.0)
        finally:
            store_mod.set_redundancy_fault_hook(None)
        assert fired and fired[0]["holder"] == "holder0"
        assert got == body

    def test_put_shard_into_either_store(self, stores):
        store, _ = stores
        body = np.random.RandomState(2).bytes(50_000)
        port.put_shard(store.url, "own", 4, 1, memoryview(body), timeout=5.0)
        assert bytes(store.get("own", 4, 1)) == body
        ref.put_shard(store.url, "own", 4, 2, body, timeout=5.0)
        assert bytes(store.get("own", 4, 2)) == body
        status = json.loads(urllib.request.urlopen(
            f"{store.url}/redundancy/store/status", timeout=5).read().decode())
        assert status["generations"] == [{"owner": "own", "step": 4, "shards": [1, 2]}]

    def test_short_body_is_truncation_not_hang(self):
        store = port.ShardStore("holder0")
        try:
            store.put("own", 3, 0, b"y" * 1024)
            with pytest.raises(IOError, match="truncated"):
                port.get_shard(store.url, "own", 3, 0, 2048, shard_crc(b"y" * 1024), timeout=5.0)
            with pytest.raises(ValueError, match="buffer"):
                port.get_shard_into(bytearray(10), store.url, "own", 3, 0, 1024, 0, timeout=5.0)
        finally:
            store.shutdown()

    def test_retain_drops_old_generations_and_shutdown_frees_and_joins(self):
        store = port.ShardStore("holder0", retain=1)
        store.put("own", 1, 0, b"a" * 10)
        store.put("own", 2, 0, b"b" * 10)
        assert [g["step"] for g in store.status()["generations"]] == [2]
        store.shutdown()
        assert store.status()["generations"] == []
        assert not _threads_named("torchft_shard_store_holder0")


def _torch_state(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "model": {"w": torch.randn(33, 17, generator=g).to(torch.bfloat16),
                  "b": torch.randn(5, generator=g)},
        "optim": {"state": {0: {"step": torch.tensor(3.0),
                                "exp_avg": torch.randn(33, 17, generator=g)}},
                  "param_groups": [{"lr": 3e-4, "params": [0]}]},
        "ids": torch.arange(7, dtype=torch.int64),
        "empty": torch.zeros(0, 4),
        "torchft": {"step": 5, "batches_committed": 10},
    }


def _assert_same_leaves(a, b):
    la, da = torch.utils._pytree.tree_flatten(a)
    lb, db = torch.utils._pytree.tree_flatten(b)
    assert da == db
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.reshape(-1).view(torch.uint8).tolist() == \
                y.reshape(-1).view(torch.uint8).tolist()
        else:
            assert x == y


class TestReconstruct:
    K, M = 2, 1

    def _stage(self, directory, owner, step, state, stores, seq=1):
        blob = port.pack_state_blob(state)
        shards = encode_shards(blob, self.K, self.M)
        _, resp = directory.register(owner, "pod0", "", False)
        entries = []
        for i, (shard, holder) in enumerate(zip(shards, stores)):
            holder.put(owner, step, i, bytes(shard))
            entries.append({"idx": i, "crc": shard_crc(shard), "url": holder.url,
                            "holder": holder.replica_id})
        code, aresp = directory.announce({
            "replica_id": owner, "epoch": resp["epoch"], "seq": seq, "step": step,
            "k": self.K, "m": self.M, "data_len": len(blob), "shards": entries,
        })
        assert code == 200, aresp
        return blob

    @pytest.fixture()
    def stores(self):
        ss = [port.ShardStore(f"holder{i}") for i in range(self.K + self.M)]
        yield ss
        for s in ss:
            s.shutdown()

    def test_parallel_reconstruct_is_bitwise(self, directory, stores):
        state = _torch_state(2)
        self._stage(directory, "own", 5, state, stores)
        step, got, stats = port.reconstruct_state(directory.url, owner="own", timeout=10.0,
                                                  max_workers=3)
        assert step == 5
        assert self.K <= stats["shards_ok"] <= self.K + self.M
        assert stats["shards_failed"] == stats["shards_corrupt"] == 0
        _assert_same_leaves(got, state)

    def test_dead_data_holder_fails_over_to_parity(self, directory, stores):
        state = _torch_state(3)
        self._stage(directory, "own", 5, state, stores)
        stores[0].shutdown()  # a data shard's holder
        step, got, stats = port.reconstruct_state(directory.url, owner="own", timeout=10.0,
                                                  max_workers=3)
        assert stats["shards_failed"] == 1 and stats["shards_ok"] == self.K
        _assert_same_leaves(got, state)

    def test_corrupt_shard_is_caught_and_repaired(self, directory, stores):
        state = _torch_state(4)
        self._stage(directory, "own", 6, state, stores)
        events = []

        def corrupt_data1(event, info):
            return "corrupt" if event == "shard_get" and info["idx"] == 1 else None

        port.set_redundancy_fault_hook(corrupt_data1)
        try:
            _, got, stats = port.reconstruct_state(
                directory.url, owner="own", timeout=10.0, max_workers=3,
                on_event=lambda kind, info: events.append((kind, info["idx"])))
        finally:
            port.set_redundancy_fault_hook(None)
        assert stats["shards_corrupt"] == 1 and stats["shards_ok"] == self.K
        assert ("shard_corrupt", 1) in events
        _assert_same_leaves(got, state)

    def test_reconstruct_lands_in_place_in_a_template(self, directory, stores):
        state = _torch_state(5)
        self._stage(directory, "own", 7, state, stores)
        stores[1].shutdown()
        template = _torch_state(99)
        ptrs = [t.data_ptr() for t in torch.utils._pytree.tree_leaves(template)
                if isinstance(t, torch.Tensor)]
        _, got, _ = port.reconstruct_state(directory.url, owner="own", timeout=10.0,
                                           template=template)
        _assert_same_leaves(got, state)
        _assert_same_leaves(template, state)
        assert [t.data_ptr() for t in torch.utils._pytree.tree_leaves(got)
                if isinstance(t, torch.Tensor)] == ptrs

    def test_a_step_no_owner_announced_raises_before_anything_lands(self, directory, stores):
        self._stage(directory, "own", 5, _torch_state(6), stores)
        template = _torch_state(99)
        before = [t.clone() for t in torch.utils._pytree.tree_leaves(template)
                  if isinstance(t, torch.Tensor)]
        gets = []
        port.set_redundancy_fault_hook(lambda event, info: gets.append(event) and None)
        try:
            for owner in (None, "own"):
                with pytest.raises(IOError, match="step 6|not 6"):
                    port.reconstruct_state(directory.url, owner=owner, step=6, timeout=2.5,
                                           template=template)
        finally:
            port.set_redundancy_fault_hook(None)
        assert gets == []
        after = [t for t in torch.utils._pytree.tree_leaves(template) if isinstance(t, torch.Tensor)]
        assert all(torch.equal(a, b) for a, b in zip(before, after))

    def test_a_retired_holders_shard_fails_without_a_fetch(self, directory):
        stores = [port.ShardStore(f"h{i}:a") for i in range(self.K + self.M)]
        try:
            for st in stores:
                directory.register(st.replica_id, "pod0", st.url, False)
            state = _torch_state(8)
            self._stage(directory, "own", 5, state, stores)
            directory.register("h0:b", "pod0", OWN_URL, False)  # h0's restart
            holders = []
            port.set_redundancy_fault_hook(
                lambda event, info: holders.append(info["holder"]) and None)
            try:
                step, got, stats = port.reconstruct_state(directory.url, step=5, timeout=10.0)
            finally:
                port.set_redundancy_fault_hook(None)
            assert step == 5 and (stats["shards_ok"], stats["shards_failed"]) == (2, 1)
            assert sorted(holders) == ["h1:a", "h2:a"]  # data shard 0 rebuilt from parity
            _assert_same_leaves(got, state)
        finally:
            for st in stores:
                st.shutdown()

    def test_step_targeted_reconstruct_waits_for_announce(self, directory, stores):
        old = {"w": torch.zeros(64)}
        new = {"w": torch.randn(64, generator=torch.Generator().manual_seed(4))}
        self._stage(directory, "own", 5, old, stores, seq=1)

        def late_announce():
            time.sleep(0.3)
            self._stage(directory, "own", 6, new, stores, seq=2)

        t = threading.Thread(target=late_announce)
        t.start()
        try:
            step, got, _ = port.reconstruct_state(directory.url, step=6, timeout=10.0,
                                                  max_workers=3)
        finally:
            t.join()
        assert step == 6
        assert torch.equal(got["w"], new["w"])

    def test_pack_unpack_leaves_are_the_references_bytes(self):
        """The same arrays packed by each package unpack to equal leaf
        bytes (the blobs themselves differ in their pickled spec)."""
        rng = np.random.RandomState(5)
        arrays = {"w": rng.randn(17, 3).astype(np.float32), "i": np.arange(9, dtype=np.int32)}
        mine = port.unpack_state_blob(port.pack_state_blob(
            {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}))
        theirs = ref.unpack_state_blob(ref.pack_state_blob(arrays))
        for k in arrays:
            assert mine[k].numpy().tobytes() == np.asarray(theirs[k]).tobytes() == arrays[k].tobytes()
        got = port.unpack_state_blob(port.pack_state_blob({"w": torch.ones(3), "step": 9}))
        assert got["step"] == 9 and torch.equal(got["w"], torch.ones(3))

    def test_pack_copies_a_snapshot(self):
        live = {"w": torch.zeros(1000)}
        blob = port.pack_state_blob(live)
        live["w"].add_(1.0)  # the next step cannot tear the staged generation
        assert torch.equal(port.unpack_state_blob(blob)["w"], torch.zeros(1000))


class TestStagerAndSpare:
    def test_stager_stages_and_a_spare_prefetches_then_both_join_on_shutdown(self, directory):
        holders = [port.ShardStager(port.RedundancyConfig(k=2, m=1, directory=directory.url,
                                                          retain=1), f"r{i}")
                   for i in range(3)]
        cfg = port.RedundancyConfig(k=2, m=1, directory=directory.url)
        spare = port.HotSpare(cfg, "sp", poll_s=0.02)
        metrics = {}
        try:
            state = _torch_state(6)
            holders[0]._on_metric = lambda name, value: metrics.__setitem__(name, value)
            assert holders[0].stage(4, state)
            assert holders[0].wait_staged(4, timeout=20)
            assert spare.wait_prefetched(4, timeout=20)
            assert {"shard_stage_snapshot_s", "shard_encode_s", "shard_put_s",
                    "shard_stage_s", "shards_staged"} <= set(metrics)
            entry = directory.directory()["entries"]["r0"]
            assert entry["step"] == 4 and {s["holder"] for s in entry["shards"]} == {"r1", "r2"}
            directory.mark_dead("r0")
            step, got, promo = spare.wait_promoted(timeout=20)
            assert step == 4 and promo["replaces"] == "r0"
            _assert_same_leaves(got, state)
        finally:
            spare.shutdown()
            for h in holders:
                h.shutdown()
        assert not _threads_named("torchft_shard_stager_") and not _threads_named("torchft_hot_spare_")
        assert not _threads_named("torchft_shard_store_")

    def test_stager_interval_skips_and_newest_wins(self, directory):
        peer = port.ShardStore("peer")
        directory.register("peer", "pod0", peer.url, False)
        stager = port.ShardStager(port.RedundancyConfig(k=2, m=1, directory=directory.url,
                                                        interval=2), "own")
        counts = {}
        stager._on_metric = lambda n, v: counts.__setitem__(n, counts.get(n, 0) + v)
        try:
            assert stager.stage(1, {"w": torch.ones(8)}) is True
            assert stager.stage(2, {"w": torch.ones(8)}) is False
            assert stager.stage(3, {"w": torch.ones(8)}) is True
            assert stager.wait_staged(3, timeout=20)
            assert counts["shard_stage_skipped"] == 1
        finally:
            stager.shutdown()
            peer.shutdown()

    def test_serve_registry_shadow_is_not_ported(self, directory):
        """The serve shadow, which raised ``NotImplementedError`` until the
        serving plane was ported, now attaches: a worker on the host that
        has applied nothing while its registry is unreachable, joined by
        the spare's shutdown."""
        spare = port.HotSpare(port.RedundancyConfig(k=2, m=1, directory=directory.url), "sp",
                              serve_registry="http://127.0.0.1:9")
        shadow = spare._serve_worker
        try:
            assert shadow is not None and shadow.device.type == "cpu"
            assert spare.status()["serve_version"] is None
        finally:
            spare.shutdown()
        assert not shadow._pull_thread.is_alive()

    def test_hot_spare_cli_prints_the_promotion(self, directory, capsys):
        result = {}
        t = threading.Thread(target=lambda: result.setdefault("rc", port.main(
            ["--hot-spare", "--directory", directory.url, "--spare-id", "cli_spare",
             "--status-interval", "0.05"])))
        t.start()
        deadline = time.monotonic() + 20
        while "cli_spare" not in directory.status()["spares"] and time.monotonic() < deadline:
            time.sleep(0.01)
        directory.register("own", "pod0", OWN_URL, False)
        directory.mark_dead("own")
        t.join(timeout=30)
        assert result.get("rc") == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last)["promoted"] is True and json.loads(last)["replaces"] == "own"


def test_metrics_registry_renders_as_the_reference():
    regs = [observability.MetricsRegistry(), ref_observability.MetricsRegistry()]
    for r in regs:
        r.gauge_set("g", 1.5, "a gauge")
        r.counter_set("c_total", 3.0)
        for v in (0.0001, 0.3, 7.0, 100.0):
            r.observe("h_seconds", v, "a histogram")
    assert regs[0].render() == regs[1].render()


def test_lighthouse_cohosts_the_directory_and_answers_health():
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, redundancy_directory=True)
    try:
        url = lh.redundancy_directory_url()
        assert port.DirectoryClient(url, timeout=5).get_directory()["entries"] == {}
        health = LighthouseClient(f"127.0.0.1:{lh.port}", connect_timeout=5).health()
        assert health["excluded"] == [] and health["replicas"] == {}
        assert health["mode"] == "observe"
    finally:
        lh.shutdown()
    assert not _threads_named("torchft_shard_directory")
    plain = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    try:
        assert plain.redundancy_directory_url() is None
    finally:
        plain.shutdown()


class TestManagerKZeroPin:
    """With the plane off (the default), a heal never enters the reconstruct
    branch and nothing talks to a directory: the heal path is the one
    before the plane (reference ``TestManagerKZeroPin``)."""

    def test_heal_with_redundancy_off_never_reconstructs(self, monkeypatch):
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupHost

        calls, dialed = [], []
        real = Manager._reconstruct_checkpoint

        def spying(self, quorum):
            calls.append(quorum)
            return real(self, quorum)

        monkeypatch.setattr(Manager, "_reconstruct_checkpoint", spying)
        monkeypatch.setattr(port.DirectoryClient, "_call",
                            lambda self, path, payload=None: dialed.append(path))
        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                              quorum_tick_ms=20, heartbeat_timeout_ms=800)

        def train(rid, out):
            g = torch.Generator().manual_seed(rid + 1)
            params = {"w": torch.randn(4, generator=g)}  # divergent

            def load_state(sd):
                params["w"].copy_(sd["w"])

            manager = Manager(
                pg=ProcessGroupHost(timeout=10.0), load_state_dict=load_state,
                state_dict=lambda: {"w": params["w"]}, min_replica_size=1,
                replica_id=f"kzero_{rid}", lighthouse_addr=f"127.0.0.1:{lh.port}",
                timeout=10.0, quorum_timeout=10.0,
            )
            assert manager._redundancy_cfg is None
            assert manager._shard_stager is None and manager._hot_spare is None
            try:
                while manager.current_step() < 3:
                    manager.start_quorum()
                    reduced = manager.allreduce({"w": torch.ones(4)}).get_future().wait(30)
                    if manager.should_commit():
                        params["w"] -= 0.1 * reduced["w"]
                out[rid] = (params["w"].clone(), manager.metrics()["heals"])
            finally:
                manager.shutdown(wait=False)

        out = {}
        try:
            threads = [threading.Thread(target=train, args=(rid, out)) for rid in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            lh.shutdown()
        assert set(out) == {0, 1}, "a replica never finished"
        assert torch.equal(out[0][0], out[1][0])
        assert out[0][1] + out[1][1] >= 1  # the heal did run ...
        assert calls == [] and dialed == []  # ... and never reached the plane

    def test_a_multi_rank_group_with_the_plane_on_raises(self, monkeypatch, directory):
        """The leader stages its own ranks' state only: a two-rank group
        would heal every rank from the leader's shards, so the plane
        refuses it, whether the environment or a config turns it on."""
        from torchft_tpu_torch.manager import Manager

        kw = dict(pg=None, load_state_dict=None, state_dict=None, min_replica_size=1,
                  lighthouse_addr="127.0.0.1:1", group_world_size=2)
        with pytest.raises(ValueError, match="one-rank replica groups"):
            Manager(**kw, redundancy=port.RedundancyConfig(k=2, m=1, directory=directory.url))
        monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "2")
        monkeypatch.setenv("TORCHFT_REDUNDANCY_DIRECTORY", directory.url)
        for rank in (0, 1):
            with pytest.raises(ValueError, match="one-rank replica groups"):
                Manager(**kw, group_rank=rank, store_addr="127.0.0.1:1")
        assert directory.status()["peers"] == []  # nothing registered

    def test_stage_hot_s_is_in_timings_on_the_rounds_that_stage(self, directory):
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupHost

        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                              quorum_tick_ms=20)
        params = {"w": torch.zeros(4)}
        manager = Manager(
            pg=ProcessGroupHost(timeout=10.0), load_state_dict=lambda sd: None,
            state_dict=lambda: {"w": params["w"]}, min_replica_size=1, replica_id="hot",
            lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=10.0,
            redundancy=port.RedundancyConfig(k=2, m=1, directory=directory.url, interval=2),
        )
        seen = []
        try:
            for _ in range(5):
                manager.start_quorum()
                seen.append("shard_stage_hot_s" in manager.timings())
                manager.allreduce({"w": torch.ones(4)}).get_future().wait(30)
                assert manager.should_commit()
        finally:
            manager.shutdown(wait=False)
            lh.shutdown()
        # the round after the 1st and the 3rd commit stage, the 2nd and 4th skip
        assert seen == [False, True, False, True, False]
        assert manager.timings()["shard_stage_skipped"] == 2

    def test_bad_config_raises_before_anything_starts(self, monkeypatch):
        from torchft_tpu_torch.manager import Manager

        monkeypatch.setenv("TORCHFT_REDUNDANCY_K", "2")
        monkeypatch.setenv("TORCHFT_REDUNDANCY_M", "0")
        with pytest.raises(ValueError, match="TORCHFT_REDUNDANCY_M"):
            Manager(pg=None, load_state_dict=None, state_dict=None, min_replica_size=1,
                    lighthouse_addr="127.0.0.1:1")
        monkeypatch.delenv("TORCHFT_REDUNDANCY_K")
        monkeypatch.delenv("TORCHFT_REDUNDANCY_M")
        with pytest.raises(ValueError, match="shard directory"):
            Manager(pg=None, load_state_dict=None, state_dict=None, min_replica_size=1,
                    spare=True)
