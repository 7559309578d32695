"""The port's HTTP checkpoint transport, wire v3, against the JAX package's.

Each scenario of ``tests/test_checkpointing.py``'s v3 cases (multi-chunk
single leaf, mid-stream corruption, a corrupt chunk fetched again, a stall
resumed at its verified offset, failover to a second peer mid-heal, a v2
sender restarting a chunk) runs on both packages with the same seeded
state and fault, and the port must deliver the same state with the same
resilience counters and events. For equal staged states the port's chunk
bodies and crc32 trailers (whole, and resumed from an offset) are the
reference's byte for byte. Also: a v1 sender, ``client_only``, a forced
``num_chunks`` and the in-place receive into a template.
"""

import http.server
import logging
import pickle
import struct
import threading
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import http_transport as ref_ht
from torchft_tpu.checkpointing import HTTPTransport as RefHTTP
from torchft_tpu.retry import RetryPolicy as RefPolicy
from torchft_tpu_torch.checkpointing import http_transport as port_ht
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.checkpointing._serialization import flatten_state
from torchft_tpu_torch.retry import RetryPolicy


class _Pkg:
    def __init__(self, port: bool) -> None:
        self.port = port
        self.HTTP = HTTPTransport if port else RefHTTP
        self.module = port_ht if port else ref_ht

    def policy(self, attempts: int = 3):
        cls = RetryPolicy if self.port else RefPolicy
        return cls(max_attempts=attempts, base_s=0.0, jitter=0.0)

    def state(self, tree):
        """The scenario's state in this package's leaves: torch tensors for
        the port, numpy for the reference (sorted keys: both packages then
        flatten the leaves in one order)."""
        if isinstance(tree, dict):
            return {k: self.state(tree[k]) for k in sorted(tree)}
        if isinstance(tree, np.ndarray) and self.port:
            return torch.from_numpy(tree.copy())
        return tree


REF, PORT = _Pkg(False), _Pkg(True)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["reference", "port"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state(out, tree) -> None:
    assert sorted(out) == sorted(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            _assert_state(out[k], v)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(_np(out[k]), v)
        else:
            assert out[k] == v


def _scenario(pkg, tree, fault=None, src_chunks=4, attempts=3, fallback=False,
              version=None, monkeypatch=None):
    """Stage ``tree`` on a source (and a fallback), arm ``fault`` on the
    source, receive through recv_checkpoint_multi; returns (state, stats
    counters, events)."""
    if version is not None:
        monkeypatch.setattr(pkg.module, "_WIRE_VERSION", version)
    src = pkg.HTTP(timeout=10.0, num_chunks=src_chunks)
    fb = pkg.HTTP(timeout=10.0, num_chunks=src_chunks) if fallback else None
    dst = pkg.HTTP(timeout=10.0, retry_policy=pkg.policy(attempts), client_only=True)
    events = []
    try:
        state = pkg.state(tree)
        src.send_checkpoint([1], 7, state, 10.0)
        if fb is not None:
            fb.send_checkpoint([1], 7, state, 10.0)
        if fault is not None:
            src.inject_chunk_fault(*fault)
        sources = [("primary", lambda: src.metadata())]
        if fb is not None:
            sources.append(("fallback", lambda: fb.metadata()))
        out = dst.recv_checkpoint_multi(
            sources, step=7, timeout=10.0,
            on_event=lambda kind, **f: events.append((kind, {k: f[k] for k in f
                                                             if k not in ("error", "prior_error")})),
        )
        stats = dst.last_recv_timings()
        return out, (stats.num_chunks, stats.total_bytes, stats.retries, stats.failovers,
                     stats.crc_failures), events
    finally:
        for t in (src, fb, dst):
            if t is not None:
                t.shutdown()


def _both(tree, **kw):
    """The scenario on the reference, then the port: both deliver ``tree``,
    with the same counters and events."""
    results = []
    for pkg in (REF, PORT):
        out, counters, events = _scenario(pkg, tree, **kw)
        _assert_state(out, tree)
        results.append((counters, events))
    assert results[1] == results[0]
    return results[1]


def test_single_leaf_multi_chunk_bitwise_as_the_reference():
    (num_chunks, total, *_), _ev = _both({"params": {"w": np.arange(262_144, dtype=np.float32)}})
    assert num_chunks == 4 and total == 262_144 * 4


@BOTH
def test_mid_stream_corruption_aborts(pkg):
    """Overlapping ranges (one chunk served twice) abort the receive."""
    src = pkg.HTTP(timeout=5.0, num_chunks=4)
    dst = pkg.HTTP(timeout=5.0, client_only=True)
    try:
        src.send_checkpoint([1], 7, pkg.state({"w": np.arange(262_144, dtype=np.float32)}), 5.0)
        step, spec, payloads, assignments = src._staged
        src._staged = (step, spec, payloads, [assignments[0]] * 2)
        with pytest.raises((ConnectionError, OSError, RuntimeError)):
            dst.recv_checkpoint(0, src.metadata(), 7, 5.0)
    finally:
        src.shutdown()
        dst.shutdown()


def test_corrupt_chunk_refetched_as_the_reference():
    (_, _, retries, failovers, crc_failures), events = _both(
        {"w": np.arange(65_536, dtype=np.float32)}, fault=(2, "corrupt", 1))
    assert (retries, failovers, crc_failures) == (1, 0, 1)
    assert [e for e in events if e[0] == "chunk_crc_failure"] == [
        ("chunk_crc_failure", {"chunk": 2, "source": "primary"})]


def test_stall_resumes_at_the_verified_offset_as_the_reference():
    tree = {"w": np.arange(262_144, dtype=np.float32)}
    (_, _, retries, _, _), events = _both(tree, fault=(0, "die", 1), src_chunks=1)
    assert retries == 1
    (kind, fields), = events
    assert kind == "heal_retry" and 0 < fields["resume_offset"] < tree["w"].nbytes


def test_failover_to_a_second_peer_mid_heal_as_the_reference():
    tree = {"step": 42, "w": np.arange(262_144, dtype=np.float32)}
    (_, _, _, failovers, _), events = _both(tree, fault=(0, "die", -1), src_chunks=2,
                                            attempts=2, fallback=True)
    assert failovers == 1
    assert [f["source"] for k, f in events if k == "heal_failover"] == ["fallback"]


def test_v2_sender_restarts_a_chunk_without_resume_as_the_reference(monkeypatch):
    (_, _, retries, _, _), events = _both({"w": np.arange(65_536, dtype=np.float32)},
                                          fault=(1, "die", 1), src_chunks=2, version=2,
                                          monkeypatch=monkeypatch)
    assert retries == 1
    assert [f["resume_offset"] for k, f in events if k == "heal_retry"] == [0]


def test_all_sources_exhausted_raises():
    with pytest.raises(RuntimeError, match="all 2/2 source"):
        src = HTTPTransport(timeout=5.0, num_chunks=1)
        dst = HTTPTransport(timeout=5.0, retry_policy=PORT.policy(2), client_only=True)
        try:
            src.send_checkpoint([1], 2, {"w": torch.arange(4096.0)}, 5.0)
            src.inject_chunk_fault(0, "die", times=-1)
            dst.recv_checkpoint_multi([("p", src.metadata), ("q", src.metadata)], 2, 5.0)
        finally:
            src.shutdown()
            dst.shutdown()


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_chunk_bodies_and_crc_trailers_equal_the_reference_bytewise():
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(3000).astype(np.float32), "b": rng.randn(17, 5).astype(np.float16),
            "c": np.arange(10, dtype=np.int64), "d": np.zeros(0, np.float32)}
    ref, port = RefHTTP(timeout=10.0, num_chunks=3), HTTPTransport(timeout=10.0, num_chunks=3)
    try:
        ref.send_checkpoint([1], 11, REF.state(tree), 10.0)
        port.send_checkpoint([1], 11, PORT.state(tree), 10.0)
        assert port._staged[3] == ref._staged[3]  # the wire plan
        for i in range(len(ref._staged[3])):
            for query in ("", "?crc=1", "?crc=1&offset=37"):
                want = _get(f"{ref.metadata()}/checkpoint/11/chunk_{i}{query}")
                got = _get(f"{port.metadata()}/checkpoint/11/chunk_{i}{query}")
                assert got == want, (i, query)
        meta = pickle.loads(_get(f"{port.metadata()}/checkpoint/11/metadata"))
        assert meta[1:] == (3, 3)  # (spec, num_chunks, wire version)
    finally:
        ref.shutdown()
        port.shutdown()


def test_v1_sender_is_understood():
    """A v1 sender: metadata ``(spec, num_chunks)``, whole-leaf ``[leaf_idx,
    nbytes]`` frames, no crc, no resume."""
    state = {"w": torch.arange(1000, dtype=torch.float32), "z": torch.ones(3, 4)}
    spec, payloads = flatten_state(state)
    chunks = [[0], [1]]

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            what = self.path.split("?")[0].rstrip("/").split("/")[-1]
            if what == "metadata":
                body = pickle.dumps((spec, len(chunks)))
            else:
                body = b"".join(struct.pack("<qq", j, len(bytes(payloads[j]))) + bytes(payloads[j])
                                for j in chunks[int(what[len("chunk_"):])])
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    dst = HTTPTransport(timeout=5.0, client_only=True)
    try:
        out = dst.recv_checkpoint(0, f"http://127.0.0.1:{server.server_address[1]}", 3, 5.0)
        assert torch.equal(out["w"], state["w"]) and torch.equal(out["z"], state["z"])
    finally:
        server.shutdown()
        server.server_close()


def test_client_only_binds_no_port():
    t = HTTPTransport(timeout=1.0, client_only=True)
    assert t._server is None
    with pytest.raises(RuntimeError, match="client_only"):
        t.metadata()
    with pytest.raises(RuntimeError, match="client_only"):
        t.send_checkpoint([1], 0, {"w": torch.ones(2)}, 1.0)
    t.shutdown()


@pytest.mark.parametrize("num_chunks", [1, 5])
def test_num_chunks_is_forced(num_chunks):
    src = HTTPTransport(timeout=5.0, num_chunks=num_chunks)
    dst = HTTPTransport(timeout=5.0, client_only=True)
    try:
        state = {"w": torch.arange(50_000, dtype=torch.float32), "s": 3}
        src.send_checkpoint([1], 1, state, 5.0)
        assert len(src._staged[3]) == num_chunks
        assert src.staged_step() == 1
        out = dst.recv_checkpoint(0, src.metadata(), 1, 5.0)
        assert torch.equal(out["w"], state["w"]) and out["s"] == 3
        assert dst.last_recv_timings().num_chunks == num_chunks
        src.disallow_checkpoint(grace=0.0)
        assert src.staged_step() is None
    finally:
        src.shutdown()
        dst.shutdown()


def test_in_place_template_keeps_data_ptr(caplog):
    """A CPU tensor template leaf takes the socket's bytes in its own
    memory: the received tree holds the template's tensors, data_ptr()
    kept, values the sender's. A leaf the template cannot absorb (another
    dtype) degrades with a warning and comes off the wire."""
    sent = {"b": torch.full((7,), 2.5, dtype=torch.bfloat16),
            "w": torch.randn(300, 11, generator=torch.Generator().manual_seed(3)),
            "x": torch.arange(6, dtype=torch.int32)}
    template = {"b": torch.zeros(7, dtype=torch.bfloat16),
                "w": torch.zeros(300, 11, requires_grad=True),
                "x": torch.zeros(6, dtype=torch.int64)}
    ptrs = {k: v.data_ptr() for k, v in template.items()}
    src = HTTPTransport(timeout=5.0, num_chunks=3)
    dst = HTTPTransport(timeout=5.0, client_only=True, state_dict_template=lambda: template)
    try:
        src.send_checkpoint([1], 4, sent, 5.0)
        with caplog.at_level(logging.WARNING):
            out = dst.recv_checkpoint(0, src.metadata(), 4, 5.0)
    finally:
        src.shutdown()
        dst.shutdown()
    for k in ("b", "w"):
        assert out[k] is template[k] and out[k].data_ptr() == ptrs[k]
        assert torch.equal(out[k].detach(), sent[k])
    assert out["x"] is not template["x"] and torch.equal(out["x"], sent["x"])
    assert "in-place receive degraded" in caplog.text


def test_state_dict_template_must_be_callable():
    with pytest.raises(TypeError, match="zero-arg callable"):
        HTTPTransport(client_only=True, state_dict_template={"w": torch.ones(1)})


@pytest.mark.parametrize("query,code", [("?crc=1&offset=abc", 500), ("?offset=999999999", 404),
                                        ("", 404)])
def test_malformed_chunk_requests_are_answered(query, code):
    """A bad offset or chunk index gets an error status, never a body."""
    import urllib.error

    src = HTTPTransport(timeout=5.0, num_chunks=1)
    try:
        src.send_checkpoint([1], 2, {"w": torch.ones(8)}, 5.0)
        chunk = "chunk_0" if query else "chunk_9"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{src.metadata()}/checkpoint/2/{chunk}{query}")
        assert e.value.code == code
        # the transport still serves
        assert len(_get(f"{src.metadata()}/checkpoint/2/chunk_0")) == 24 + 32
    finally:
        src.shutdown()
