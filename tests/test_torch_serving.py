"""The serving plane in the port against the reference
(``torchft_tpu/serving.py``): the counterparts of ``tests/test_serving.py``
(config and validation, the codec, deterministic flatten, the registry
protocol, drain before eject, delta against full pull in every mode, lag
past ``max_lag``, the worker failover matrix, the publisher's lifecycle,
the worker loop), each value held bit for bit against the reference's
objects on the same seeded numpy inputs (the port's CPU path is the host
codec, so the tolerance is zero); then what only the port has (the
snapshot buffer reused by ``publish_async``, a co-publisher that skipped a
version full-pulling back onto the chain, the record's wire without its
device), the
Manager's commit-path hook, and the slice as a whole: two debug-Llama
replicas with a crash after the backward pass and a serve worker, whose
published chain a reference publisher replays to the same ``R``.

Everything runs on loopback HTTP with small flats.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu import serving as ref
from torchft_tpu_torch import healthwatch as port_health
from torchft_tpu_torch import serving as port
from torchft_tpu_torch.ops.quantization import CompressedWire

Version = Tuple[int, int]


def _cfg(mod, registry: str = "", **kw):
    base = dict(registry=registry, max_lag=8, compress="fp8", poll_s=0.02, timeout_s=5.0)
    base.update(kw)
    return mod.ServeConfig(**base)


def _params(n: int = 1024, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(n).astype(np.float32)}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _worker(reg_url: str, cfg, name: str, start: bool = False) -> "port.ServeWorker":
    return port.ServeWorker(reg_url, config=cfg, name=name, start=start, device="cpu")


def _wire_bytes(wire) -> Tuple[bytes, bytes]:
    if isinstance(wire, (bytes, bytearray)):
        return bytes(wire), b""
    return np.ascontiguousarray(wire.payload).tobytes(), np.ascontiguousarray(wire.scales).tobytes()


def _ref_chain(versions: List[Tuple[Version, Dict[str, np.ndarray]]], mode: str):
    """A registry-less reference publisher fed ``versions`` in order."""
    pub = ref.SnapshotPublisher("ref", config=_cfg(ref, compress=mode), registry_url="")
    for (q, s), params in versions:
        assert pub.publish(q, s, params) == (q, s)
    return pub


@pytest.fixture(autouse=True)
def _clear_fault_hooks():
    yield
    port.set_serve_fault_hook(None)
    ref.set_serve_fault_hook(None)


# ---------------------------------------------------------------- config
class TestServeConfig:
    def test_from_env_overrides(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_SERVE_MAX_LAG", "3")
        monkeypatch.setenv("TORCHFT_SERVE_COMPRESS", "int8")
        monkeypatch.setenv("TORCHFT_SERVE_DRAIN_ON", "eject")
        monkeypatch.setenv("TORCHFT_SERVE_TIMEOUT_S", "7.5")
        got, want = port.ServeConfig.from_env(), ref.ServeConfig.from_env()
        assert got.to_json() == want.to_json()
        assert (got.max_lag, got.compress, got.drain_on) == (3, "int8", "eject")
        # explicit overrides beat the environment
        assert port.ServeConfig.from_env(max_lag=9).max_lag == 9

    @pytest.mark.parametrize("field,value", [("max_lag", 0), ("compress", "zstd"),
                                             ("drain_on", "never"), ("poll_s", 0.0),
                                             ("timeout_s", -1.0)])
    def test_validate_rejects(self, field, value):
        for mod in (port, ref):
            with pytest.raises(ValueError) as e:
                _cfg(mod, **{field: value}).validate()
            # the message names the variable, as the reference's does
            assert "TORCHFT_SERVE_" in str(e.value)

    @pytest.mark.parametrize("mode", ["off", "fp8", "int8"])
    def test_codec_roundtrip_matches_reference(self, mode):
        """``off`` is raw f32 bytes; fp8 and int8 the bucket codec. The
        port's wire and decode equal the reference's byte for byte."""
        delta = np.linspace(-1, 1, 257, dtype=np.float32)
        delta[7] = 3e-9  # a value far below its row's scale
        wire = port.encode_delta(torch.from_numpy(delta), mode)
        want_wire = ref.encode_delta(delta, mode)
        assert _wire_bytes(wire) == _wire_bytes(want_wire)
        out = port.decode_delta(wire, mode, delta.size)
        assert out.dtype == torch.float32 and tuple(out.shape) == delta.shape
        np.testing.assert_array_equal(_np(out), ref.decode_delta(want_wire, mode, delta.size))
        assert port.delta_nbytes(wire) == ref.delta_nbytes(want_wire)
        if mode == "off":
            np.testing.assert_array_equal(_np(out), delta)
        else:
            assert wire.device is None

    def test_flatten_params_deterministic_and_signed_as_the_reference(self):
        rng = np.random.RandomState(4)
        bf = rng.randn(3, 5).astype(ml_dtypes.bfloat16)
        tree = {"b": 1.0, "a": np.arange(6, dtype=np.float32).reshape(2, 3),
                "layers.10.w": rng.randn(4).astype(np.float32),
                "layers.2.w": rng.randn(2, 2).astype(np.float32)}
        f1, l1 = port.flatten_params(tree)
        f2, l2 = port.flatten_params(tree)
        np.testing.assert_array_equal(_np(f1), _np(f2))
        want, wl = ref.flatten_params(tree)
        np.testing.assert_array_equal(_np(f1), want)
        assert l1 == l2 == wl
        # a torch bf16 leaf carries numpy's dtype name: the same sig
        t_bf = torch.from_numpy(bf.view(np.uint16).copy()).view(torch.bfloat16)
        got, gl = port.flatten_params({"x": t_bf, "y": torch.ones(3)})
        want, wl = ref.flatten_params({"x": bf, "y": np.ones(3, np.float32)})
        np.testing.assert_array_equal(_np(got), want)
        assert gl["sig"] == wl["sig"]

    @pytest.mark.parametrize("n", [7, 128, 1000])
    def test_answer_from_flat_matches_reference(self, n):
        flat = np.random.RandomState(n).randn(n).astype(np.float32)
        for seed in (0, 1, 42, 10**6 + 3):
            assert port.answer_from_flat(torch.from_numpy(flat), seed) == \
                ref.answer_from_flat(flat, seed)
        assert port.answer_from_flat(None, 0) is None


# ---------------------------------------------------------------- registry
def _announce(reg, rid, epoch, seq, version, chain="c1"):
    return reg.announce({"replica_id": rid, "epoch": epoch, "seq": seq,
                         "quorum_id": version[0], "step": version[1],
                         "full_url": "http://127.0.0.1:1/full",
                         "delta_url": "http://127.0.0.1:1/delta", "chain": chain})


def _protocol_script(mod) -> List:
    """The reference test's announce script; the answers it gets."""
    reg = mod.SnapshotRegistry()
    try:
        epoch = reg.register("r0")[1]["epoch"]
        out = []
        for seq, v in ((1, (1, 5)), (2, (1, 5)), (3, (1, 4)), (1, (1, 6)), (4, (1, 7)),
                       (5, (2, 8))):
            code, resp = _announce(reg, "r0", epoch, seq, v)
            out.append((code, resp.get("error"), resp.get("latest")))
        return out
    finally:
        reg.shutdown()


class TestRegistryProtocol:
    def test_version_monotone_across_reconfigure(self):
        """Per-replica versions are strictly monotone on (quorum_id, step):
        replays and rewinds get 409, a seq replay too, and a reconfigure
        (quorum_id bumps, the step keeps counting) is accepted."""
        got = _protocol_script(port)
        assert got == _protocol_script(ref)
        assert [c for c, _, _ in got] == [200, 409, 409, 409, 200, 200]
        assert [e for _, e, _ in got][1:4] == ["stale_version", "stale_version", "stale_seq"]
        assert got[-1][2] == [2, 8]

    def test_stale_registry_rejection_after_restart(self):
        reg = port.SnapshotRegistry()
        port_no = reg._server.server_address[1]
        try:
            old_epoch = reg.register("r0")[1]["epoch"]
            assert _announce(reg, "r0", old_epoch, 1, (1, 0))[0] == 200
        finally:
            reg.shutdown()
        # the registry restarts on the same port: a fresh epoch, no sources
        reg2 = port.SnapshotRegistry(port=port_no)
        try:
            assert reg2.epoch != old_epoch
            code, resp = _announce(reg2, "r0", old_epoch, 2, (1, 1))
            assert code == 409 and resp["error"] == "stale_epoch"
            assert reg2.sources()["sources"] == []
            # the publisher registers again by itself
            pub = port.SnapshotPublisher("r0", config=_cfg(port), registry_url=reg2.url)
            try:
                pub._epoch, pub._seq = old_epoch, 7
                assert pub.publish(1, 2, _params()) == (1, 2)
                listing = reg2.sources()
                assert listing["latest"] == [1, 2]
                assert listing["sources"][0]["replica_id"] == "r0"
            finally:
                pub.shutdown()
        finally:
            reg2.shutdown()

    def test_sources_order_drained_at_tail(self):
        for mod in (port, ref):
            reg = mod.SnapshotRegistry()
            try:
                b0, b1 = reg.register("r0")[1], reg.register("r1")[1]
                assert _announce(reg, "r0", b0["epoch"], 1, (1, 3))[0] == 200
                assert _announce(reg, "r1", b1["epoch"], 1, (1, 4))[0] == 200
                assert [s["replica_id"] for s in reg.sources()["sources"]] == ["r1", "r0"]
                reg.drain("r1", True)
                listing = reg.sources()
                assert [s["replica_id"] for s in listing["sources"]] == ["r0", "r1"]
                assert listing["sources"][1]["draining"] is True
                assert listing["latest"] == [1, 3]
                # a fully drained fleet still serves
                reg.drain("r0", True)
                listing = reg.sources()
                assert len(listing["sources"]) == 2 and listing["latest"] == [1, 4]
            finally:
                reg.shutdown()

    def test_registry_client_structured_409_not_retried(self):
        reg = port.SnapshotRegistry()
        try:
            client = port.RegistryClient(reg.url, timeout=3.0)
            epoch = client.register("r0")
            body = {"replica_id": "r0", "epoch": epoch, "seq": 1, "quorum_id": 1, "step": 0,
                    "full_url": "u", "delta_url": "u", "chain": "c"}
            assert client.announce(body)[0] == 200
            t0 = time.monotonic()
            code, resp = client.announce(body)  # a seq replay
            assert code == 409 and resp["error"] == "stale_seq"
            assert time.monotonic() - t0 < 1.0
        finally:
            reg.shutdown()


# ------------------------------------------------------- drain-before-eject
def _health(states: Dict[str, str], excluded=()) -> Dict:
    return {"replicas": {r: {"state": s} for r, s in states.items()}, "excluded": list(excluded)}


class TestDrainBeforeEject:
    def test_warn_drains_before_eject(self):
        """Under drain_on="warn" the replica leaves the serving set at WARN,
        before training ejects it, in both packages; back to ok, back in."""
        script = [({"r0": "ok", "r1": "ok"}, ()), ({"r0": "ok", "r1": "warn"}, ()),
                  ({"r0": "ok", "r1": "ejected"}, ("r1",)), ({"r0": "ok", "r1": "ok"}, ())]
        seen = {}
        for mod in (port, ref):
            reg = mod.SnapshotRegistry(drain_on="warn")
            try:
                for rid in ("r0", "r1"):
                    assert _announce(reg, rid, reg.register(rid)[1]["epoch"], 1, (1, 1))[0] == 200
                seen[mod] = []
                for states, excluded in script:
                    reg.apply_health(_health(states, excluded))
                    seen[mod].append(reg.sources()["draining"])
            finally:
                reg.shutdown()
        assert seen[port] == seen[ref] == [[], ["r1"], ["r1"], []]

    def test_eject_policy_serves_through_warn(self):
        reg = port.SnapshotRegistry(drain_on="eject")
        try:
            assert _announce(reg, "r0", reg.register("r0")[1]["epoch"], 1, (1, 1))[0] == 200
            reg.apply_health(_health({"r0": "warn"}))
            assert reg.sources()["draining"] == []
            reg.apply_health(_health({"r0": "ejected"}))
            assert reg.sources()["draining"] == ["r0"]
        finally:
            reg.shutdown()

    def test_serving_eligible_matrix(self):
        from torchft_tpu.healthwatch import serving_eligible as ref_eligible

        for state in ("ok", "warn", "ejected", "probation", "gibberish"):
            for policy in ("warn", "eject"):
                assert port_health.serving_eligible(state, policy) == ref_eligible(state, policy)
        assert not port_health.serving_eligible("gibberish", "warn")
        with pytest.raises(ValueError):
            port_health.serving_eligible("ok", "sometimes")

    def test_ledger_escalation_drives_drain_ordering(self):
        cfg = port_health.HealthConfig(mode="eject", window=8, min_samples=3, warn_z=2.0,
                                       eject_z=4.0, eject_steps=2, probation_ms=1000,
                                       probe_ok=2)
        ledger = port_health.HealthLedger(cfg, min_replicas=1)
        drained_at: Optional[int] = None
        ejected_at: Optional[int] = None
        for step in range(20):
            now_ms = (step + 1) * 1000.0
            for rid, step_s in (("fast1", 1.0), ("fast2", 1.0), ("slow", 40.0)):
                ledger.on_heartbeat(rid, {"step": step, "step_s": step_s, "wire_s": 0.0}, now_ms)
            state = ledger.state_of("slow")
            if drained_at is None and not port_health.serving_eligible(state, "warn"):
                drained_at = step
            if state.name.lower() == "ejected":
                ejected_at = step
                break
        assert drained_at is not None and ejected_at is not None
        assert drained_at <= ejected_at


# ------------------------------------------------------- wire equivalence
class TestBitwiseEquivalence:
    @pytest.mark.parametrize("mode", ["off", "fp8", "int8"])
    def test_delta_vs_full_bitwise_equal(self, mode):
        """Worker A full-pulls v0 then walks deltas to v4; worker B cold
        full-pulls v4. Both equal the port publisher's R bit for bit, which
        equals a reference publisher's R after the same versions, and every
        delta's codes and scales are the reference's, byte for byte."""
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url, compress=mode)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        wa = _worker(reg.url, cfg, "wa")
        chain: List[Tuple[Version, Dict[str, np.ndarray]]] = []
        try:
            params = _params(2048, seed=3)
            assert pub.publish(1, 0, params) == (1, 0)
            chain.append(((1, 0), {"w": params["w"].copy()}))
            assert wa.pull_once() and wa.version == (1, 0)
            for step in range(1, 5):
                params["w"] = params["w"] * np.float32(0.999) + np.float32(0.01 * step)
                assert pub.publish(1, step, params) == (1, step)
                chain.append(((1, step), {"w": params["w"].copy()}))
                assert wa.pull_once()
            assert wa.version == (1, 4)
            assert (wa.counters["full_pulls_total"], wa.counters["delta_pulls_total"]) == (1, 4)
            wb = _worker(reg.url, cfg, "wb")
            try:
                assert wb.pull_once() and wb.version == (1, 4)
                assert (wb.counters["full_pulls_total"], wb.counters["delta_pulls_total"]) == (1, 0)
                r = _np(pub.ref_flat())
                np.testing.assert_array_equal(_np(wa.params_flat()), r)
                np.testing.assert_array_equal(_np(wb.params_flat()), r)
                want = _ref_chain(chain, mode)
                try:
                    np.testing.assert_array_equal(r, want.ref_flat())
                    for v, _ in chain:
                        got_rec = port.load_record(pub.delta_blob(v))
                        want_rec = pickle.loads(want.delta_blob(v))
                        assert _wire_bytes(got_rec["wire"]) == _wire_bytes(want_rec["wire"])
                        assert got_rec["prev"] == want_rec["prev"]
                        assert got_rec["layout_sig"] == want_rec["layout_sig"]
                finally:
                    want.shutdown()
                if mode == "off":
                    np.testing.assert_allclose(r, params["w"], rtol=1e-6, atol=1e-7)
            finally:
                wb.shutdown()
        finally:
            wa.shutdown()
            pub.shutdown()
            reg.shutdown()

    def test_delta_moves_fewer_bytes(self):
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        w = _worker(reg.url, cfg, "w")
        try:
            params = _params(8192, seed=1)
            pub.publish(1, 0, params)
            assert w.pull_once()
            params["w"] = params["w"] + np.float32(0.5)
            pub.publish(1, 1, params)
            assert w.pull_once()
            c = w.counters
            assert c["full_bytes_total"] > 3 * c["delta_bytes_total"] > 0
        finally:
            w.shutdown()
            pub.shutdown()
            reg.shutdown()

    def test_lag_beyond_max_forces_full_pull(self):
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url, max_lag=2)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        w = _worker(reg.url, cfg, "w")
        try:
            params = _params(1024, seed=2)
            pub.publish(1, 0, params)
            assert w.pull_once() and w.version == (1, 0)
            for step in range(1, 5):
                params["w"] = params["w"] + np.float32(0.1)
                pub.publish(1, step, params)
            assert len(pub.manifest()["deltas"]) == 2
            assert w.pull_once() and w.version == (1, 4)
            assert (w.counters["full_pulls_total"], w.counters["delta_pulls_total"]) == (2, 0)
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pub.ref_flat()))
        finally:
            w.shutdown()
            pub.shutdown()
            reg.shutdown()


# ------------------------------------------------------- failover matrix
class TestWorkerFailover:
    def _fleet(self, mode: str = "fp8", n: int = 2048):
        """A registry and two lockstep publishers holding identical state,
        R equal to a reference publisher's after the same versions."""
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url, compress=mode)
        pubs = [port.SnapshotPublisher(f"r{i}", config=cfg, registry_url=reg.url)
                for i in range(2)]
        params = _params(n, seed=11)
        chain = []
        for step in range(2):
            if step:
                params["w"] = params["w"] + np.float32(0.25)
            chain.append(((1, step), {"w": params["w"].copy()}))
            for pub in pubs:
                # a co-publisher's first publish adopts the version the other
                # announced (None: "already covered")
                assert pub.publish(1, step, params) in ((1, step), None)
        assert [p.version for p in pubs] == [(1, 1), (1, 1)]
        want = _ref_chain(chain, mode)
        try:
            for p in pubs:
                np.testing.assert_array_equal(_np(p.ref_flat()), want.ref_flat())
        finally:
            want.shutdown()
        assert pubs[1].counters["bootstrap_pulls_total"] == 1
        return reg, cfg, pubs, params

    def _teardown(self, reg, pubs, *workers):
        for w in workers:
            w.shutdown()
        for p in pubs:
            p.shutdown()
        reg.shutdown()

    def test_full_pull_fails_over_dead_source(self):
        reg, cfg, pubs, _ = self._fleet()
        w = _worker(reg.url, cfg, "w")
        try:
            pubs[0].kill()  # dead at connect: both endpoints gone
            assert w.pull_once() and w.version == (1, 1)
            assert w.counters["pull_failovers_total"] >= 1
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pubs[1].ref_flat()))
        finally:
            self._teardown(reg, pubs, w)

    def test_full_pull_fails_over_mid_stream(self):
        reg, cfg, pubs, _ = self._fleet(n=8192)
        w = _worker(reg.url, cfg, "w")
        try:
            # every serve of r0's chunk dies halfway through its span
            pubs[0]._transport.inject_chunk_fault(0, "die", times=-1)
            assert w.pull_once() and w.version == (1, 1)
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pubs[1].ref_flat()))
            assert w.counters["pull_failovers_total"] >= 1
        finally:
            self._teardown(reg, pubs, w)

    def test_delta_pull_fails_over_dead_source(self):
        reg, cfg, pubs, params = self._fleet()
        w = _worker(reg.url, cfg, "w")
        try:
            assert w.pull_once() and w.version == (1, 1)
            pubs[0].kill()
            params["w"] = params["w"] + np.float32(0.5)
            assert pubs[1].publish(1, 2, params) == (1, 2)
            assert w.pull_once() and w.version == (1, 2)
            assert w.counters["delta_pulls_total"] >= 1
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pubs[1].ref_flat()))
        finally:
            self._teardown(reg, pubs, w)

    def test_delta_pull_fails_over_dropped_connection(self):
        """r0 answers its manifest but drops every delta blob's connection;
        the worker fails over to r1 and still lands bitwise."""
        reg, cfg, pubs, params = self._fleet()
        w = _worker(reg.url, cfg, "w")
        try:
            assert w.pull_once() and w.version == (1, 1)
            port.set_serve_fault_hook(
                lambda event, info: "die" if event == "delta_request"
                and info["replica_id"] == "r0" else None)
            params["w"] = params["w"] + np.float32(0.5)
            for pub in pubs:
                assert pub.publish(1, 2, params) == (1, 2)
            assert w.pull_once() and w.version == (1, 2)
            assert w.counters["pull_failovers_total"] >= 1
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pubs[1].ref_flat()))
        finally:
            port.set_serve_fault_hook(None)
            self._teardown(reg, pubs, w)

    def test_infer_never_fails_during_source_loss(self):
        """``/infer`` answers from the applied snapshot under the worker's
        lock: killing every source fails no request, over HTTP too. The
        fleet runs under the port's lock-order detector, as the
        reference's test runs under its own: an acquisition inversion
        among the registry, the publishers and the worker fails here even
        when the deadlocking schedule never fires."""
        import json
        import urllib.request

        from torchft_tpu_torch.analysis import lockgraph

        with lockgraph.watch() as graph:
            reg, cfg, pubs, _ = self._fleet()
            w = _worker(reg.url, cfg, "w")
            try:
                assert w.pull_once()
                before = w.answer(seed=42)
                for p in pubs:
                    p.kill()
                assert w.pull_once() is False  # nothing new reachable
                after = w.answer(seed=42)
                assert before["result"] == after["result"] is not None
                assert after["version"] == [1, 1]
                with urllib.request.urlopen(f"{w.url}/infer?seed=42", timeout=5) as r:
                    body = json.loads(r.read().decode())
                assert body["result"] == before["result"]
                assert before["result"] == ref.answer_from_flat(_np(w.params_flat()), 42)
            finally:
                self._teardown(reg, pubs, w)
        lockgraph.assert_clean(graph)


# ------------------------------------------------------- publisher lifecycle
class TestPublisherLifecycle:
    def test_bootstrap_joins_existing_chain(self):
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        p0 = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        try:
            params = _params(1024, seed=5)
            p0.publish(1, 0, params)
            params["w"] = params["w"] + np.float32(0.1)
            p0.publish(1, 1, params)
            p1 = port.SnapshotPublisher("r1", config=cfg, registry_url=reg.url)
            try:
                params["w"] = params["w"] + np.float32(0.1)
                assert p1.publish(1, 2, params) == (1, 2)
                assert p1.chain == p0.chain
                assert p1.counters["bootstrap_pulls_total"] == 1
                w = _worker(reg.url, cfg, "w")
                try:
                    assert w.pull_once() and w.version == (1, 2)
                    np.testing.assert_array_equal(_np(w.params_flat()), _np(p1.ref_flat()))
                finally:
                    w.shutdown()
            finally:
                p1.shutdown()
        finally:
            p0.shutdown()
            reg.shutdown()

    def test_counters_exact_under_concurrent_publishes(self):
        """Every count and every read of the publisher's counters takes
        their lock: synchronous publishes from four threads (serialized by
        the publish lock, as the publish thread's and publish()'s are)
        and more counting threads than cores against two threads reading
        ``counters`` the whole time end with ``published_total`` equal to
        the publishes that returned a version (one at or below the newest
        is covered and returns None), ``delta_bytes_total`` equal to that
        many deltas' bytes and every count made; every read is a copy, and
        no read sees a total move backwards."""
        cfg = _cfg(port)
        one = port.SnapshotPublisher("one", config=cfg)
        try:
            one.publish(1, 0, _params(256))
            delta_bytes = one.counters["delta_bytes_total"]
        finally:
            one.shutdown()
        pub = port.SnapshotPublisher("r0", config=cfg)
        writers, per = 4, 12
        stop = threading.Event()
        published: List[int] = []
        seen: List[Dict[str, int]] = []
        errors: List[BaseException] = []

        def publish(t: int) -> None:
            try:
                for i in range(per):
                    if pub.publish(1, i * writers + t, _params(256, seed=t * per + i)):
                        published.append(1)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def read() -> None:
            while not stop.is_set():
                c = pub.counters
                c["published_total"] = -1  # a copy: the publisher's stay
                seen.append(pub.counters)

        def count(n: int) -> None:
            for _ in range(n):
                pub._count("skipped_total")

        readers = [threading.Thread(target=read) for _ in range(2)]
        threads = [threading.Thread(target=publish, args=(t,)) for t in range(writers)]
        # more counting threads than cores, switching as often as the
        # interpreter allows: a read-modify-write outside the lock loses
        # counts here
        counters = [threading.Thread(target=count, args=(5000,))
                    for _ in range(2 * (os.cpu_count() or 1) + 2)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for th in readers + threads + counters:
                th.start()
            for th in threads + counters:
                th.join(60)
                assert not th.is_alive()
            stop.set()
            for th in readers:
                th.join(10)
                assert not th.is_alive()
            assert not errors, errors
            c = pub.counters
            assert published and c["published_total"] == len(published)
            assert c["delta_bytes_total"] == len(published) * delta_bytes
            assert c["skipped_total"] == 5000 * len(counters)
            assert c["k3_host_launches"] == c["k4_launches"] == 0
            totals = [x["published_total"] for x in seen]
            assert seen and totals == sorted(totals) and totals[-1] <= len(published)
        finally:
            sys.setswitchinterval(interval)
            stop.set()
            pub.shutdown()

    def test_async_publish_drop_oldest(self):
        """publish_async never blocks on the encode and keeps the newest
        pending version; R equals a reference publisher's that published
        the same versions (read from the port's ring) in order."""
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        try:
            params = _params(1024, seed=9)
            sent = {}
            for step in range(6):
                params["w"] = params["w"] + np.float32(0.01)
                sent[(1, step)] = {"w": params["w"].copy()}
                pub.publish_async(1, step, params)
            assert pub.flush(timeout=5.0)
            assert pub.version == (1, 5)
            published = [tuple(v) for v in pub.manifest()["deltas"]]
            assert published[-1] == (1, 5)
            assert pub.counters["published_total"] + pub.counters["skipped_total"] == 6
            want = _ref_chain([(v, sent[v]) for v in published], "fp8")
            try:
                np.testing.assert_array_equal(_np(pub.ref_flat()), want.ref_flat())
            finally:
                want.shutdown()
            w = _worker(reg.url, cfg, "w")
            try:
                assert w.pull_once() and w.version == pub.version
                np.testing.assert_array_equal(_np(w.params_flat()), _np(pub.ref_flat()))
            finally:
                w.shutdown()
        finally:
            pub.shutdown()
            reg.shutdown()

    def test_layout_change_resets_chain(self):
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        w = _worker(reg.url, cfg, "w")
        try:
            pub.publish(1, 0, _params(512, seed=1))
            assert w.pull_once()
            chain0 = pub.chain
            pub.publish(1, 1, _params(768, seed=1))  # the model grew
            assert pub.chain != chain0
            assert w.pull_once() and w.version == (1, 1)
            assert w.counters["full_pulls_total"] == 2
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pub.ref_flat()))
        finally:
            w.shutdown()
            pub.shutdown()
            reg.shutdown()


class TestWorkerLoop:
    def test_background_loop_tracks_publishes(self):
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url, poll_s=0.01)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        w = _worker(reg.url, cfg, "w", start=True)
        try:
            params = _params(1024, seed=4)
            pub.publish(1, 0, params)
            assert w.wait_version((1, 0), timeout=5.0)
            params["w"] = params["w"] + np.float32(0.2)
            pub.publish(1, 1, params)
            assert w.wait_version((1, 1), timeout=5.0)
            np.testing.assert_array_equal(_np(w.params_flat()), _np(pub.ref_flat()))
            assert w.status()["lag_steps"] == 0
        finally:
            w.shutdown()
            pub.shutdown()
            reg.shutdown()

    def test_entry_points_need_cuda_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        reg = port.SnapshotRegistry()
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                port.ServeWorker(reg.url, config=_cfg(port, reg.url), start=False)
        finally:
            reg.shutdown()


# ------------------------------------------------------- the port's own paths
class TestPortPublisher:
    def test_async_snapshot_is_not_torn_by_the_next_step(self, monkeypatch):
        """publish_async copies the parameters before it returns: writing
        them in place right after (the optimizer's step) and publishing the
        next version into the same buffer while the thread still holds the
        first item leave every published version with its own values."""
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        pub = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
        gate = threading.Event()
        entered = threading.Event()
        orig = port.SnapshotPublisher._maybe_bootstrap

        def held(self, *a, **kw):
            entered.set()
            gate.wait(10)
            return orig(self, *a, **kw)

        monkeypatch.setattr(port.SnapshotPublisher, "_maybe_bootstrap", held)
        try:
            w = torch.from_numpy(_params(1536, seed=6)["w"])
            sent = {(1, 0): w.numpy().copy()}
            pub.publish_async(1, 0, {"w": w})
            assert entered.wait(5)  # the thread holds version 0
            w.mul_(1.5)  # the next optimizer step, in place
            sent[(1, 1)] = w.numpy().copy()
            pub.publish_async(1, 1, {"w": w})  # overwrites the buffer
            w.add_(7.0)
            gate.set()
            assert pub.flush(5.0)
            published = [tuple(v) for v in pub.manifest()["deltas"]]
            assert published[-1] == (1, 1)
            want = _ref_chain([(v, {"w": sent[v]}) for v in published], "fp8")
            try:
                np.testing.assert_array_equal(_np(pub.ref_flat()), want.ref_flat())
            finally:
                want.shutdown()
            # version 0 lost the buffer to version 1 while held: skipped
            assert published == [(1, 1)] and pub.counters["skipped_total"] == 1
        finally:
            gate.set()
            pub.shutdown()
            reg.shutdown()

    def test_record_wire_carries_no_device_and_decodes_anywhere(self):
        pub = port.SnapshotPublisher("r0", config=_cfg(port), registry_url="")
        try:
            pub.publish(3, 4, {"w": torch.arange(1000, dtype=torch.float32)})
            rec = port.load_record(pub.delta_blob((3, 4)))
            assert isinstance(rec["wire"], CompressedWire) and rec["wire"].device is None
            assert (rec["quorum_id"], rec["step"], rec["prev"], rec["n"]) == (3, 4, None, 1000)
            out = port.decode_delta(rec["wire"], rec["mode"], rec["n"], "cpu")
            np.testing.assert_array_equal(_np(out), _np(pub.ref_flat()))
        finally:
            pub.shutdown()

    @pytest.mark.parametrize("skip_publish", [True, False])
    def test_co_publisher_behind_full_pulls_onto_the_chain(self, skip_publish):
        """r1 misses version 2 that r0 published. At version 3 it full-pulls
        r0's newest ``R``, whether r0 already announced version 3 (the
        shortcut must see that r0's 3 extends 2, not r1's 1) or not, and
        both stay bitwise equal: the reference's shortcut would publish a
        forked delta here."""
        reg = port.SnapshotRegistry()
        cfg = _cfg(port, reg.url)
        p0, p1 = (port.SnapshotPublisher(f"r{i}", config=cfg, registry_url=reg.url)
                  for i in range(2))
        try:
            params = _params(2048, seed=12)
            for step in range(2):
                params["w"] = params["w"] + np.float32(0.3)
                for p in (p0, p1):
                    p.publish(1, step, params)
            params["w"] = params["w"] * np.float32(0.9)
            assert p0.publish(1, 2, params) == (1, 2)  # r1 skips this one
            params["w"] = params["w"] - np.float32(0.2)
            if skip_publish:
                assert p0.publish(1, 3, params) == (1, 3)
                assert p1.publish(1, 3, params) is None  # covered by the pull
            else:
                assert p1.publish(1, 3, params) == (1, 3)
                assert p0.publish(1, 3, params) == (1, 3)
            # its first version, and the re-seat on r0's newest
            assert p1.counters["bootstrap_pulls_total"] == 2
            np.testing.assert_array_equal(_np(p0.ref_flat()), _np(p1.ref_flat()))
            w = _worker(reg.url, cfg, "w")
            try:
                assert w.pull_once() and w.version == (1, 3)
                np.testing.assert_array_equal(_np(w.params_flat()), _np(p0.ref_flat()))
            finally:
                w.shutdown()
        finally:
            for p in (p0, p1):
                p.shutdown()
            reg.shutdown()


# ------------------------------------------------------- the Manager's hook
class _RecordingPublisher:
    def __init__(self, fail: bool = False) -> None:
        self.calls: List[Tuple[int, int, Dict]] = []
        self.fail = fail

    def publish_async(self, quorum_id, step, params):
        if self.fail:
            raise RuntimeError("publisher down")
        self.calls.append((quorum_id, step, {k: v.clone() for k, v in params.items()}))


@pytest.mark.parametrize("fail", [False, True])
def test_manager_publishes_each_commit_before_the_step_advances(fail):
    """``attach_serve_publisher``: every committed step is handed over as
    ``(quorum_id, step)`` with the step that voted, before the optimizer
    writes; a failing publisher is counted, never a failed commit."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupDummy

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                          quorum_tick_ms=10)
    w = torch.nn.Parameter(torch.zeros(4))
    opt = torch.optim.SGD([w], lr=1.0)
    mgr = Manager(pg=ProcessGroupDummy(), load_state_dict=lambda sd: None,
                  state_dict=lambda: {"w": w.detach()}, min_replica_size=1,
                  replica_id="serve_hook", lighthouse_addr=f"127.0.0.1:{lh.port}",
                  timeout=10.0, use_async_quorum=False, metrics_port=0)
    pub = _RecordingPublisher(fail=fail)
    mgr.attach_serve_publisher(pub, params_fn=lambda: {"w": w})
    try:
        for _ in range(3):
            mgr.start_quorum()
            w.grad = torch.ones(4)
            assert mgr.should_commit()
            opt.step()
        t = mgr.timings()
        if fail:
            assert pub.calls == [] and t["serve_publish_errors_total"] == 3
            assert t["serve_published_total"] == 0
        else:
            assert [(s) for _, s, _ in pub.calls] == [0, 1, 2]
            assert [c[2]["w"][0].item() for c in pub.calls] == [0.0, -1.0, -2.0]
            assert t["serve_published_total"] == 3 and t["serve_publish_errors_total"] == 0
            assert all(q == mgr.current_quorum_id() for q, _, _ in pub.calls)
        assert t["serve_publish_s"] >= 0.0
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{mgr.metrics_port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        total = "serve_publish_errors_total" if fail else "serve_published_total"
        assert f"torchft_manager_{total} 3.0" in body
        assert "torchft_manager_serve_publish_seconds_count 3" in body
    finally:
        mgr.shutdown()
        lh.shutdown()


# ------------------------------------------------------- the slice as a whole
def test_trainer_serves_through_a_crash_and_heal_bitwise_as_the_reference(monkeypatch):
    """Two debug-Llama replicas, ``serve_workers=1``, replica 1 crashing
    after step 2's backward pass and healing over HTTP: the worker answers
    every request; every publisher's R and the worker's flat are equal, and
    equal to a reference publisher's R fed the committed parameters (as
    numpy trees by the names ``convert.py`` uses) of the versions the
    port's chain published, in order."""
    from torchft_tpu_torch import train

    sent: Dict[Version, Dict[str, np.ndarray]] = {}
    rings: List[Dict] = []
    lock = threading.Lock()
    orig_async = port.SnapshotPublisher.publish_async
    orig_shutdown = port.SnapshotPublisher.shutdown

    def recording_async(self, quorum_id, step, params):
        with lock:
            sent.setdefault((quorum_id, step), {
                k: (v.detach().float().numpy().astype(ml_dtypes.bfloat16)
                    if v.dtype == torch.bfloat16 else v.detach().numpy().copy())
                for k, v in params.items()})
        return orig_async(self, quorum_id, step, params)

    def recording_shutdown(self):
        with lock:
            m = self.manifest()
            rings.append(dict(zip(map(tuple, m["deltas"]),
                                  [tuple(p) if p else None for p in m["prevs"]])))
        return orig_shutdown(self)

    monkeypatch.setattr(port.SnapshotPublisher, "publish_async", recording_async)
    monkeypatch.setattr(port.SnapshotPublisher, "shutdown", recording_shutdown)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fleet: Dict = {}
    try:
        cfg = train.TrainConfig(config="debug", steps=5, seq_len=16, quantize=True,
                                faults=(train.Fault(1, 2, "crash", at="backward"),),
                                serve_workers=1)
        results = train.run_replicas(cfg, "cpu", fleet=fleet)
    finally:
        torch.set_num_threads(n)
    assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
    sv = fleet["serving"]
    assert sv["equal"]
    assert sv["requests"]["ok"] > 0 and sv["requests"]["failed"] == []
    digests = {p["ref_sha256"] for p in sv["publishers"]} | {w["flat_sha256"]
                                                              for w in sv["workers"]}
    assert len(digests) == 1
    assert sv["publishers"][1]["counters"]["bootstrap_pulls_total"] >= 1
    # the chain: prev pointers back from the newest version, over every
    # publisher's ring (the crashed incarnation's included)
    prevs: Dict[Version, Optional[Version]] = {}
    for ring in rings:
        prevs.update(ring)
    v: Optional[Version] = tuple(sv["target"])
    path = []
    while v is not None:
        path.append(v)
        v = prevs[v]
    path.reverse()
    assert path[0][1] == 0 and path[-1] == tuple(sv["target"])
    want = _ref_chain([(v, sent[v]) for v in path], "fp8")
    try:
        import hashlib

        assert hashlib.sha256(want.ref_flat().tobytes()).hexdigest() in digests
    finally:
        want.shutdown()


def test_cli_runs_a_registry_and_a_worker():
    """``python -m torchft_tpu_torch.serving registry|worker``: each prints
    its JSON line and serves; the worker pulls what a publisher announces
    to the registry and answers ``/infer``."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def start(*args):
        proc = subprocess.Popen([sys.executable, "-m", "torchft_tpu_torch.serving", *args],
                                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                text=True, start_new_session=True)
        return proc, json.loads(proc.stdout.readline())

    reg_proc, reg = start("registry", "--port", "0", "--drain-on", "eject")
    procs = [reg_proc]
    try:
        with urllib.request.urlopen(f"{reg['registry']}/serve/status", timeout=10) as r:
            assert json.loads(r.read().decode())["drain_on"] == "eject"
        w_proc, w = start("worker", "--registry", reg["registry"], "--device", "cpu",
                          "--name", "cli_w")
        procs.append(w_proc)
        assert w["worker"] == "cli_w"
        pub = port.SnapshotPublisher("r0", config=_cfg(port, reg["registry"]),
                                     registry_url=reg["registry"])
        try:
            assert pub.publish(1, 0, _params(600, seed=8)) == (1, 0)
            deadline = time.monotonic() + 30
            body = {}
            while body.get("version") != [1, 0] and time.monotonic() < deadline:
                with urllib.request.urlopen(f"{w['url']}/infer?seed=5", timeout=10) as r:
                    body = json.loads(r.read().decode())
                time.sleep(0.05)
            assert body["version"] == [1, 0]
            assert body["result"] == ref.answer_from_flat(_np(pub.ref_flat()), 5)
        finally:
            pub.shutdown()
    finally:
        for p in procs:
            os.killpg(p.pid, signal.SIGINT)
            p.wait(timeout=20)


def test_trainer_cli_takes_the_serving_flags(monkeypatch, capsys):
    """``--serve-workers`` / ``--serve-compress`` reach the config; the run's
    serving summary is printed last, and a run whose workers and
    publishers differ exits non-zero."""
    import json

    from torchft_tpu_torch import train

    seen = {}

    def fake(cfg, device, on_step, fleet):
        seen["cfg"] = cfg
        fleet["serving"] = {
            "equal": seen.get("equal", True), "target": [1, 2],
            "publishers": [{"replica": 0, "version": [1, 2], "counters": {}, "ref_sha256": "a"}],
            "workers": [{"name": "w", "version": [1, 2], "counters": {}, "flat_sha256": "a"}],
            "requests": {"ok": 3, "failed": [], "latency_ms": [1.0, 2.0, 3.0], "seconds": 1.0}}
        return []

    monkeypatch.setattr(train, "run_replicas", fake)
    train.main(["--config", "debug", "--serve-workers", "2", "--serve-compress", "int8"])
    cfg = seen["cfg"]
    assert (cfg.serve_workers, cfg.serve_compress) == (2, "int8")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["serving"]["equal"] is True and last["serving"]["requests_ok"] == 3
    seen["equal"] = False
    with pytest.raises(SystemExit):
        train.main(["--config", "debug", "--serve-workers", "1"])
    with pytest.raises(SystemExit):
        train.main(["--config", "debug", "--serve-compress", "zstd"])


def test_bootstrap_lists_again_when_the_sources_moved_on(monkeypatch):
    """A fresh publisher's bootstrap pull can reach its source after the
    source staged a newer version (a source serves its newest only): the
    pull fails, and the bootstrap lists again and pulls the newer version
    instead of starting a fresh chain."""
    reg = port.SnapshotRegistry()
    cfg = _cfg(port, reg.url)
    p0 = port.SnapshotPublisher("r0", config=cfg, registry_url=reg.url)
    p1 = port.SnapshotPublisher("r1", config=cfg, registry_url=reg.url)
    params = _params(1024, seed=13)
    orig = port.pull_full_snapshot
    calls = []

    def moved_on(sources, version, **kw):
        calls.append(tuple(version))
        if len(calls) == 1:
            # r0 publishes the next version while r1's listing says (1, 1)
            params["w"] = params["w"] + np.float32(0.3)
            assert p0.publish(1, 2, params) == (1, 2)
        return orig(sources, version, **kw)

    try:
        for step in range(2):
            params["w"] = params["w"] + np.float32(0.1)
            p0.publish(1, step, params)
        monkeypatch.setattr(port, "pull_full_snapshot", moved_on)
        assert p1.publish(1, 2, params) is None  # covered by the bootstrap
        assert calls == [(1, 1), (1, 2)]
        assert p1.counters["bootstrap_pulls_total"] == 1
        assert (p1.chain, p1.version) == (p0.chain, (1, 2))
        np.testing.assert_array_equal(_np(p1.ref_flat()), _np(p0.ref_flat()))
    finally:
        p0.shutdown()
        p1.shutdown()
        reg.shutdown()
