"""The port's knob registry and its override layer against the JAX
package's (``torchft_tpu/knobs.py``), the port's reads routed through it,
and the two knobs the port ignored before it had the registry
(``TORCHFT_MANAGER_PORT``, ``TORCHFT_METRICS_PER_REPLICA_LIMIT``)."""

import ast
import os
import pathlib
import re
import socket
import urllib.request

import pytest

from torchft_tpu import knobs as ref_knobs
from torchft_tpu_torch import knobs

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "torchft_tpu_torch"
NAME = re.compile(r"^TORCHFT_[A-Z0-9_]+$")

# the reference's knobs the port does not read yet, each with its plane
UNREAD = {
    # the degrade plane (item 6)
    "TORCHFT_DEGRADE", "TORCHFT_DEGRADE_MIN_DEGREE", "TORCHFT_DEGRADE_RESTORE",
    # the XLA process group (item 5)
    "TORCHFT_XLA_HEARTBEAT_SEC", "TORCHFT_HOST",
    # the JAX package's layer scan and Pallas splash tiles: no reader in
    # the port (its CUDA tiles are fixed, ops/attention.py)
    "TORCHFT_TPU_SCAN_UNROLL", "TORCHFT_TPU_SPLASH_BLOCK", "TORCHFT_TPU_SPLASH_BLOCK_KV",
}


def _port_sources():
    return sorted(p for p in PORT.rglob("*.py") if p != PORT / "knobs.py")


def _names_in_code(path: pathlib.Path):
    """Every TORCHFT_* string literal of a module's code (docstrings and
    comments hold longer text, never the bare name)."""
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and NAME.match(n.value)}


def test_registry_holds_exactly_the_knobs_the_port_reads():
    read = set().union(*(_names_in_code(p) for p in _port_sources()))
    assert set(knobs.REGISTRY) == read
    assert read <= set(ref_knobs.REGISTRY), read - set(ref_knobs.REGISTRY)
    assert set(ref_knobs.REGISTRY) - set(knobs.REGISTRY) == UNREAD
    assert len(knobs.REGISTRY) == len(ref_knobs.REGISTRY) - len(UNREAD)


@pytest.mark.parametrize("name", sorted(knobs.REGISTRY))
def test_each_knob_matches_the_reference_entry(name):
    port, ref = knobs.REGISTRY[name], ref_knobs.REGISTRY[name]
    assert port.name == name
    assert (port.type, port.default, port.doctor, port.summary) == \
        (ref.type, ref.default, ref.doctor, ref.summary)
    assert port.doc == "README.md#knobs"


def test_readme_lists_every_registered_knob_with_its_default():
    text = (REPO / "README.md").read_text()
    section = text[text.index("### Knobs"):]
    section = section[:section.index("\n## ")]
    for name, knob in knobs.REGISTRY.items():
        rows = [line for line in section.splitlines() if line.startswith(f"| `{name}` |")]
        assert len(rows) == 1, name
        default = f"`{knob.default}`" if knob.default else "unset"
        assert f"| {default} |" in rows[0], (name, rows[0])


def _is_environ(node):
    return (isinstance(node, ast.Attribute) and node.attr == "environ") or (
        isinstance(node, ast.Name) and node.id == "environ")


def _env_reads(tree):
    """(line, name node) of every read of the process environment:
    ``environ.get`` / ``[...]`` / ``pop`` / ``setdefault``, ``getenv`` and
    ``in environ``."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.args:
            if (n.func.attr in ("get", "pop", "setdefault") and _is_environ(n.func.value)) \
                    or n.func.attr == "getenv":
                yield n.lineno, n.args[0]
        elif isinstance(n, ast.Subscript) and _is_environ(n.value) and isinstance(n.ctx, ast.Load):
            yield n.lineno, n.slice
        elif isinstance(n, ast.Compare) and any(_is_environ(c) for c in n.comparators):
            yield n.lineno, n.left


def test_no_module_reads_a_knob_outside_knobs():
    """An environment read outside knobs.py names a literal that is no
    TORCHFT_* knob (RANK, CXX, ...): a knob's name, a constant that holds
    one, or any computed name fails."""
    constants = set()
    for path in _port_sources():
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, str) and NAME.match(n.value.value):
                constants.update(t.id for t in n.targets if isinstance(t, ast.Name))
    assert {"LIGHTHOUSE_ENV", "COMPRESS_ENV", "MANAGER_PORT_ENV"} <= constants
    bad = []
    for path in _port_sources():
        for line, arg in _env_reads(ast.parse(path.read_text())):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and not NAME.match(arg.value):
                continue
            bad.append(f"{path.relative_to(REPO)}:{line}: {ast.unparse(arg)}")
    assert not bad


def _override_script(mod, monkeypatch):
    """One sequence of the override layer's calls and the readers' answers,
    each entry a value or the name of the exception it raised."""
    out = []

    def attempt(fn):
        try:
            out.append(fn())
        except KeyError as e:
            out.append(("KeyError", "TORCHFT_NOT_A_KNOB" in str(e)))
        except ValueError:
            out.append("ValueError")

    monkeypatch.setenv("TORCHFT_QUORUM_RETRIES", "4")
    monkeypatch.setenv("TORCHFT_TRACE", "off")
    monkeypatch.setenv("TORCHFT_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", "")
    monkeypatch.delenv("TORCHFT_TIMEOUT_SEC", raising=False)
    reads = lambda: (  # noqa: E731
        mod.env_int("TORCHFT_QUORUM_RETRIES", 0), mod.env_bool("TORCHFT_TRACE", True),
        mod.env_float("TORCHFT_TRACE_SAMPLE", 1.0), mod.env_str("TORCHFT_LIGHTHOUSE", "dflt"),
        mod.env_raw("TORCHFT_TIMEOUT_SEC"), mod.env_raw("TORCHFT_TIMEOUT_SEC", "60"),
        mod.env_float("TORCHFT_TIMEOUT_SEC", 60.0))
    attempt(reads)
    mod.set_override("TORCHFT_QUORUM_RETRIES", "7")
    mod.set_override("TORCHFT_TIMEOUT_SEC", 12.5)
    attempt(reads)
    attempt(mod.get_overrides)
    with mod.override_scope({"TORCHFT_TRACE": "1", "TORCHFT_QUORUM_RETRIES": "9"}):
        attempt(reads)
        with mod.override_scope({"TORCHFT_QUORUM_RETRIES": "11", "TORCHFT_LIGHTHOUSE": "h:1"}):
            attempt(reads)
            attempt(mod.get_overrides)
        attempt(reads)
        # an unregistered name raises before anything changes
        attempt(lambda: mod.override_scope({"TORCHFT_TRACE": "0",
                                            "TORCHFT_NOT_A_KNOB": "1"}).__enter__())
        attempt(mod.get_overrides)
    attempt(mod.get_overrides)
    attempt(lambda: mod.set_override("TORCHFT_NOT_A_KNOB", "1"))
    attempt(lambda: mod.env_raw("TORCHFT_NOT_A_KNOB"))
    attempt(lambda: mod.env_int("TORCHFT_NOT_A_KNOB"))
    attempt(lambda: mod.env_bool("TORCHFT_NOT_A_KNOB"))
    mod.set_override("TORCHFT_TIMEOUT_SEC", None)
    attempt(reads)
    mod.set_override("TORCHFT_QUORUM_RETRIES", "not an int")
    attempt(lambda: mod.env_int("TORCHFT_QUORUM_RETRIES", 0))
    mod.clear_overrides()
    attempt(mod.get_overrides)
    attempt(reads)
    # overrides never reach the environment
    out.append(os.environ.get("TORCHFT_QUORUM_RETRIES"))
    out.append([mod.is_registered(n) for n in ("TORCHFT_TRACE", "TORCHFT_NOT_A_KNOB")])
    return out


def test_override_layer_follows_the_reference(monkeypatch):
    try:
        port = _override_script(knobs, monkeypatch)
        ref = _override_script(ref_knobs, monkeypatch)
    finally:
        knobs.clear_overrides()
        ref_knobs.clear_overrides()
    assert port == ref
    assert port[-2] == "4"
    assert ("KeyError", True) in port


def test_an_override_reaches_a_reader_as_it_does_the_reference(monkeypatch):
    """The compress resolver of both packages reads the knob through its
    registry: an override wins over the environment and over the
    argument, and a bad one raises in both."""
    from torchft_tpu.ops.quantization import resolve_compress_mode as ref_resolve
    from torchft_tpu_torch.ops.quantization import resolve_compress_mode

    monkeypatch.setenv("TORCHFT_COMPRESS", "off")
    for value in ("fp8", "int8", "bogus"):
        got = []
        for mod, resolve in ((knobs, resolve_compress_mode), (ref_knobs, ref_resolve)):
            with mod.override_scope({"TORCHFT_COMPRESS": value}):
                try:
                    got.append(resolve("off"))
                except ValueError:
                    got.append("ValueError")
        assert got[0] == got[1], (value, got)
    assert resolve_compress_mode("fp8") == ref_resolve("fp8") == "off"


def test_typed_readers_refuse_unregistered_names():
    for reader in (knobs.env_int, knobs.env_bool, knobs.env_float, knobs.env_str, knobs.env_raw):
        with pytest.raises(KeyError):
            reader("TORCHFT_NOT_A_KNOB")


def test_knobs_imports_only_the_standard_library():
    """Spawned children and import-time reads load it: nothing heavy."""
    roots = set()
    for n in ast.walk(ast.parse((PORT / "knobs.py").read_text())):
        if isinstance(n, ast.Import):
            roots.update(a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            roots.add(n.module.split(".")[0])
    assert roots <= {"__future__", "contextlib", "os", "threading", "dataclasses", "typing"}


# -- the two repaired knobs ----------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_manager_server_binds_the_manager_port(monkeypatch):
    """The group leader's ManagerServer binds $TORCHFT_MANAGER_PORT in both
    packages (reference manager.py:351-366)."""
    from torchft_tpu.coordination import LighthouseServer as RefLighthouse
    from torchft_tpu.manager import Manager as RefManager
    from torchft_tpu.process_group import ProcessGroupHost as RefPGHost
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    ports = {}
    for label, lh_cls, mgr_cls, pg_cls in (("port", LighthouseServer, Manager, ProcessGroupHost),
                                           ("ref", RefLighthouse, RefManager, RefPGHost)):
        port = _free_port()
        monkeypatch.setenv("TORCHFT_MANAGER_PORT", str(port))
        lh = lh_cls(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                    quorum_tick_ms=20, heartbeat_timeout_ms=2000)
        mgr = None
        try:
            mgr = mgr_cls(pg=pg_cls(timeout=10.0), load_state_dict=lambda sd: None,
                          state_dict=lambda: {}, min_replica_size=1, replica_id=f"bind_{label}",
                          lighthouse_addr=f"127.0.0.1:{lh.port}", timeout=10.0)
            ports[label] = (port, int(mgr._manager.address().rsplit(":", 1)[1]))
        finally:
            if mgr is not None:
                mgr.shutdown(wait=False)
            lh.shutdown()
    assert ports["port"][1] == ports["port"][0]
    assert ports["ref"][1] == ports["ref"][0]


def _replica_series(lh_cls, client_cls, monkeypatch):
    monkeypatch.setenv("TORCHFT_METRICS_PER_REPLICA_LIMIT", "2")
    lh = lh_cls(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500, quorum_tick_ms=20,
                heartbeat_timeout_ms=5000, health={"mode": "observe"})
    try:
        client = client_cls(f"127.0.0.1:{lh.port}", connect_timeout=5.0)
        for i in range(4):
            # the heartbeat RPC itself, telemetry and all, the same in both
            client._client.call("heartbeat", {
                "replica_id": f"r{i}",
                "telemetry": {"step": 1, "step_s": 0.1 * (i + 1), "wire_s": 0.01}}, 5.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{lh.port}/metrics", timeout=5.0) as r:
            text = r.read().decode()
    finally:
        lh.shutdown()
    lines = [line for line in text.splitlines() if 'replica="' in line]
    named = sorted({re.search(r'replica="([^"]+)"', line).group(1) for line in lines})
    return len(lines), named


def test_lighthouse_caps_per_replica_series_from_the_environment(monkeypatch):
    """LighthouseServer(metrics_per_replica_limit=None) reads
    $TORCHFT_METRICS_PER_REPLICA_LIMIT in both packages (reference
    coordination.py:388-392): two replicas named, the rest folded."""
    from torchft_tpu.coordination import LighthouseClient as RefClient
    from torchft_tpu.coordination import LighthouseServer as RefLighthouse
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    port = _replica_series(LighthouseServer, LighthouseClient, monkeypatch)
    ref = _replica_series(RefLighthouse, RefClient, monkeypatch)
    assert port == ref
    assert port[1] == ["_tail", "r0", "r1"]
