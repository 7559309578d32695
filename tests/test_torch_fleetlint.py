"""fleetlint in the port (``torchft_tpu_torch/analysis/``) against the
reference's (``torchft_tpu/analysis/``).

- Synthetic trees: every seeded source tree of ``tests/test_fleetlint.py``'s
  checker tests (and one of knob-table docs), each a case, through both
  packages' checkers. Both read the same contract, the port's knob
  registry and declared counters, so what is compared is the checkers:
  their ``(rule, key)`` sets (and the env reads and emissions they
  extract) must be equal.
- Real trees: the AST-only checkers (lock-discipline, blocking-calls,
  stale-guard) from either package give equal fingerprint sets over
  ``torchft_tpu/`` and over ``torchft_tpu_torch/``; a copy of the port's
  ``serving.py`` with one guard, one timeout or one stale check removed is
  found by both, with equal fingerprints.
- lockgraph: the reference's scenarios (AB/BA inversion, consistent order,
  RLock re-entry, ``Condition.wait``, hold tracking, a nested ``watch``
  refused) through both detectors, with equal cycles once each site is
  cut to its file name and line.
- The port alone: zero findings beyond its baseline, every entry
  justified, ``--ci`` exiting 0 as a subprocess (and 1 on an unjustified
  entry), fingerprints stable when a line moves, the README's knob and
  counter tables read, and the doctor's ``fleetlint`` check giving the
  reference's status for the same baseline drift.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from torchft_tpu import doctor as ref_doctor
from torchft_tpu.analysis import (
    blocking_calls as r_blocking,
    core as r_core,
    counter_contract as r_counter,
    env_contract as r_env,
    lock_discipline as r_lock,
    lockgraph as r_lockgraph,
    stale_guard as r_stale,
)
from torchft_tpu_torch import doctor, knobs
from torchft_tpu_torch.analysis import (
    CHECKER_NAMES,
    blocking_calls as p_blocking,
    contracts as p_contracts,
    core as p_core,
    counter_contract as p_counter,
    env_contract as p_env,
    lock_discipline as p_lock,
    lockgraph as p_lockgraph,
    stale_guard as p_stale,
)

REPO = Path(__file__).resolve().parents[1]
REF = {"core": r_core, "env-contract": r_env, "counter-contract": r_counter,
       "lock-discipline": r_lock, "blocking-calls": r_blocking, "stale-guard": r_stale}
PORT = {"core": p_core, "env-contract": p_env, "counter-contract": p_counter,
        "lock-discipline": p_lock, "blocking-calls": p_blocking, "stale-guard": p_stale}


@pytest.fixture()
def same_contract(monkeypatch):
    """The reference's checkers read the port's registry and counters."""
    monkeypatch.setattr(r_env, "knobs", knobs)
    monkeypatch.setattr(r_counter, "DECLARED_TIMINGS", p_contracts.DECLARED_TIMINGS)
    monkeypatch.setattr(r_counter, "DECLARED_SERIES", p_contracts.DECLARED_SERIES)


# where each package reads a doc of the synthetic trees: the reference's
# docs/ file, and the port's README subsection
_PORT_DOC = {"observability.md": "Counters", "api.md": "Knobs"}


def _write_tree(root: Path, files: dict, docs: dict, port: bool) -> Path:
    pkg = root / "pkg"
    pkg.mkdir(parents=True)
    for name, text in files.items():
        (pkg / name).write_text(textwrap.dedent(text))
    docs_dir = root / "docs"
    docs_dir.mkdir()
    if docs:
        # the port's README: the knob docs' anchor file, the reference's
        # too once the port's registry is read
        readme = "# x\n\n## PyTorch/CUDA port\n\n" + "".join(
            f"### {_PORT_DOC[name]}\n\n{textwrap.dedent(text)}\n" for name, text in docs.items())
        (docs_dir / "README.md").write_text(readme + "\n## Benchmarks\n")
    if not port:
        for name, text in docs.items():
            (docs_dir / name).write_text(textwrap.dedent(text))
    return pkg


def _both(tmp_path: Path, files: dict, docs: dict = None):
    """(reference Repo, port Repo) of the same synthetic tree."""
    repos = []
    for label, pkgs, port in (("ref", REF, False), ("port", PORT, True)):
        pkg = _write_tree(tmp_path / label, files, docs or {}, port)
        repos.append(pkgs["core"].load_repo(pkg, pkg.parent / "docs"))
    return repos


def _rules(findings) -> set:
    return {(f.rule, f.key) for f in findings}


_RACY = """
import threading

class Racy:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {"errs": 0}
        self._t = threading.Thread(target=self._loop)

    def _loop(self):
        self.counters["errs"] += 1  # written on the thread, no lock

    def read(self):
        return dict(self.counters)  # read from callers, no lock
"""
_GUARDED = _RACY.replace(
    'self.counters["errs"] += 1  # written on the thread, no lock',
    'with self._lock:\n            self.counters["errs"] += 1',
).replace(
    "return dict(self.counters)  # read from callers, no lock",
    "with self._lock:\n            return dict(self.counters)",
)
_URLOPEN = """
import urllib.request

def fetch(url):
    return urllib.request.urlopen(url).read()
"""

# case -> (checker, files, docs); the trees of tests/test_fleetlint.py
SYNTHETIC = {
    "env_unregistered_read": ("env-contract", {"mod.py": """
        import os
        a = os.environ.get("TORCHFT_NOT_A_KNOB")
        b = os.environ.get("TORCHFT_LIGHTHOUSE")  # registered
        """}, None),
    "env_constant_and_helper_indirection": ("env-contract", {"mod.py": """
        import os
        SEEDED_ENV = "TORCHFT_SEEDED_KNOB"

        def _pick(env, cast):
            return cast(os.environ.get(env, "0"))

        def from_env():
            direct = os.environ.get(SEEDED_ENV)
            via_helper = _pick("TORCHFT_HELPER_KNOB", int)
            return direct, via_helper
        """}, None),
    "env_knob_table": ("env-contract", {"mod.py": """
        from pkg import knobs
        a = knobs.env_str("TORCHFT_LIGHTHOUSE")
        b = knobs.env_int("TORCHFT_MANAGER_PORT", 0)
        """}, {"api.md": "| `TORCHFT_LIGHTHOUSE` | str |\n"}),
    "counter_undeclared_emission": ("counter-contract", {"manager.py": """
        class M:
            def step(self):
                self._record_timing("totally_new_key_s", 1.0)
                self._bump_counter("heal_attempts")  # declared
        """}, {"observability.md": "heal_attempts lives here"}),
    "counter_map_values_and_seed_loops": ("counter-contract", {"manager.py": """
        class M:
            def on_event(self, kind):
                key = {"heal_retry": "map_value_key"}.get(kind)
                if key:
                    self._bump_counter(key)

            def seed(self):
                for k in ("seeded_a", "seeded_b"):
                    self._timings[k] = 0.0
        """}, None),
    "counter_dead_declaration": ("counter-contract", {"manager.py": "class M:\n    pass\n"},
                                 {"observability.md": "all keys documented"}),
    "counter_series": ("counter-contract", {"manager.py": """
        class M:
            def scrape(self, reg):
                reg.gauge_set("torchft_manager_step", 1.0)
                reg.counter_set("torchft_manager_new_thing_total", 2.0)
        """}, {"observability.md": "torchft_manager_new_thing_total"}),
    "lock_unguarded": ("lock-discipline", {"mod.py": _RACY}, None),
    "lock_guarded": ("lock-discipline", {"mod.py": _GUARDED}, None),
    "lock_atomic_attrs": ("lock-discipline", {"mod.py": _RACY.replace(
        "class Racy:", 'class Racy:\n    _atomic_attrs = ("counters",)')}, None),
    "lock_locked_suffix": ("lock-discipline", {"mod.py": _RACY.replace(
        "def read(self):", "def read_locked(self):").replace(
        'self.counters["errs"] += 1  # written on the thread, no lock',
        'with self._lock:\n            self.counters["errs"] += 1')}, None),
    "blocking_bare_urlopen": ("blocking-calls", {"manager.py": _URLOPEN}, None),
    "blocking_timeout_and_retry_call": ("blocking-calls", {"manager.py": """
        import urllib.request
        from .retry import retry_call

        def good(url, policy):
            a = urllib.request.urlopen(url, timeout=5.0).read()
            b = retry_call(
                lambda: urllib.request.urlopen(url).read(), policy
            )
            return a, b
        """}, None),
    "blocking_cold_module": ("blocking-calls", {"launcher.py": _URLOPEN}, None),
    "stale_unguarded": ("stale-guard", {"mod.py": """
        def handle(self, msg):
            self.epoch = msg["epoch"]
            self.seq = msg["seq"]
            self.apply(msg)
        """}, None),
    "stale_monotonic_compare": ("stale-guard", {"mod.py": """
        def handle(self, msg):
            epoch, seq = msg["epoch"], msg["seq"]
            if (epoch, seq) <= (self.epoch, self.seq):
                return "stale"
            self.apply(msg)
        """}, None),
}
# what each case must find, beyond agreeing (a subset: the dead knobs and
# declarations of the whole contract come along)
EXPECT = {
    "env_unregistered_read": ({("unregistered-read", "TORCHFT_NOT_A_KNOB")},
                              {("unregistered-read", "TORCHFT_LIGHTHOUSE")}),
    "env_knob_table": ({("undocumented-knob", "TORCHFT_MANAGER_PORT")},
                       {("undocumented-knob", "TORCHFT_LIGHTHOUSE"),
                        ("dead-knob", "TORCHFT_LIGHTHOUSE")}),
    "counter_undeclared_emission": ({("undeclared-counter", "totally_new_key_s")},
                                    {("undeclared-counter", "heal_attempts"),
                                     ("undocumented-counter", "heal_attempts")}),
    "counter_dead_declaration": ({("dead-declaration", "heal_attempts")}, set()),
    "counter_series": ({("undeclared-series", "torchft_manager_new_thing_total"),
                        ("undocumented-series", "torchft_manager_step")}, set()),
    "lock_unguarded": ({("unguarded-shared-attr", "Racy.counters")}, set()),
    "blocking_bare_urlopen": ({("missing-timeout", "urllib.request.urlopen@L5")}, set()),
    "stale_unguarded": ({("missing-stale-guard", "handle")}, set()),
}
EMPTY = {"lock_guarded", "lock_atomic_attrs", "lock_locked_suffix",
         "blocking_timeout_and_retry_call", "blocking_cold_module", "stale_monotonic_compare"}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_trees_same_findings(case, tmp_path, same_contract):
    checker, files, docs = SYNTHETIC[case]
    ref_repo, port_repo = _both(tmp_path, files, docs)
    ref, port = _rules(REF[checker].check(ref_repo)), _rules(PORT[checker].check(port_repo))
    assert port == ref
    want, unwanted = EXPECT.get(case, (set(), set()))
    assert want <= port and not unwanted & port, port
    if case in EMPTY:
        assert port == set()
    if checker == "env-contract":
        assert ({n for _, _, n in p_env.collect_env_reads(port_repo)}
                == {n for _, _, n in r_env.collect_env_reads(ref_repo)})
    if checker == "counter-contract":
        assert ({k for s in port_repo.sources for k, _ in p_counter.extract_emitted(s)}
                == {k for s in ref_repo.sources for k, _ in r_counter.extract_emitted(s)})
    if case == "env_constant_and_helper_indirection":
        assert {n for _, _, n in p_env.collect_env_reads(port_repo)} >= {
            "TORCHFT_SEEDED_KNOB", "TORCHFT_HELPER_KNOB"}
    if case == "counter_map_values_and_seed_loops":
        assert {k for s in port_repo.sources for k, _ in p_counter.extract_emitted(s)} >= {
            "map_value_key", "seeded_a", "seeded_b"}


AST_ONLY = ("lock-discipline", "blocking-calls", "stale-guard")


@pytest.mark.parametrize("tree", ["torchft_tpu", "torchft_tpu_torch"])
@pytest.mark.parametrize("checker", AST_ONLY)
def test_real_trees_same_fingerprints(tree, checker):
    root = REPO / tree
    ref = {f.fingerprint for f in REF[checker].check(r_core.load_repo(root, REPO / "docs"))}
    port = {f.fingerprint for f in PORT[checker].check(p_core.load_repo(root))}
    assert port == ref
    assert port == set()  # both trees are clean on the AST-only checkers


# a guard, a timeout and a stale check taken out of a copy of serving.py
PLANTED = {
    "lock-discipline": ([("        with self._counters_lock:\n            self._counters[key] += n",
                          "        self._counters[key] += n")],
                        "lock-discipline:unguarded-shared-attr:pkg/serving.py:"
                        "SnapshotPublisher._counters"),
    "blocking-calls": ([("urllib.request.urlopen(req, timeout=timeout)",
                         "urllib.request.urlopen(req)")], None),
    "stale-guard": ([("            if epoch != self.epoch:\n", "            if False:\n"),
                     ("            if prior is not None and seq <= prior[\"seq\"]:\n",
                      "            if prior is not None and False:\n")],
                    "stale-guard:missing-stale-guard:pkg/serving.py:announce"),
}


def _planted_copy(root: Path, checker: str, shift: int = 0) -> Path:
    text = (REPO / "torchft_tpu_torch" / "serving.py").read_text()
    for old, new in PLANTED[checker][0]:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    pkg = root / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "serving.py").write_text("\n" * shift + text)
    return pkg


@pytest.mark.parametrize("checker", AST_ONLY)
def test_planted_fault_found_by_both(checker, tmp_path):
    pkg = _planted_copy(tmp_path, checker)
    ref = r_core.load_repo(pkg, tmp_path / "none")
    port = p_core.load_repo(pkg, tmp_path / "none")
    r_found = {f.fingerprint for f in REF[checker].check(ref)}
    p_found = {f.fingerprint for f in PORT[checker].check(port)}
    assert p_found == r_found and len(p_found) == 1
    want = PLANTED[checker][1]
    if want is not None:
        assert p_found == {want}
    else:
        assert next(iter(p_found)).startswith("blocking-calls:missing-timeout:pkg/serving.py:")


def test_fingerprints_stable_when_a_line_moves(tmp_path):
    found = []
    for shift in (0, 7):
        pkg = _planted_copy(tmp_path / str(shift), "lock-discipline", shift)
        found.append(p_lock.check(p_core.load_repo(pkg, tmp_path / "none")))
    (a,), (b,) = found
    assert b.line == a.line + 7 and a.fingerprint == b.fingerprint
    assert p_core.Finding("c", "r", "p.py", 10, "k", "m").fingerprint == \
        p_core.Finding("c", "r", "p.py", 99, "k", "m").fingerprint


# ----------------------------------------------------------------- lockgraph
def _ab_ba(lg):
    with lg.watch() as graph:
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        for fn in (t1, t2):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
    return graph


def _consistent(lg):
    with lg.watch() as graph:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    return graph


def _rlock_reentry(lg):
    with lg.watch() as graph:
        r = threading.RLock()

        def recurse(n):
            with r:
                if n:
                    recurse(n - 1)

        recurse(3)
    return graph


def _condition_wait(lg):
    with lg.watch() as graph:
        cond = threading.Condition()
        ready = []

        def waiter():
            with cond:
                while not ready:
                    cond.wait(timeout=5.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            ready.append(1)
            cond.notify()
        t.join(5.0)
        assert not t.is_alive()
    return graph


def _hold(lg):
    with lg.watch(hold_warn_ms=1.0) as graph:
        lk = threading.Lock()
        with lk:
            time.sleep(0.02)
    return graph


SCENARIOS = {"ab_ba_inversion": (_ab_ba, 1), "consistent_order": (_consistent, 0),
             "rlock_reentry": (_rlock_reentry, 0), "condition_wait": (_condition_wait, 0),
             "hold_tracking": (_hold, 0)}


def _site(site: str) -> str:
    path, line = site.rsplit(":", 1)
    return f"{os.path.basename(path)}:{line}"


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_lockgraph_scenarios_same_in_both(scenario):
    run, n_cycles = SCENARIOS[scenario]
    out = {}
    for name, lg in (("reference", r_lockgraph), ("port", p_lockgraph)):
        graph = run(lg)
        cycles = [[_site(s) for s in c] for c in graph.cycles()]
        holds = {_site(s) for s in graph.hold_violations()}
        edges = {(_site(a), _site(b)) for a, b in graph.edges()}
        if n_cycles:
            with pytest.raises(AssertionError, match="lock-order cycles"):
                lg.assert_clean(graph)
        else:
            lg.assert_clean(graph)
        if scenario == "hold_tracking":
            assert holds
            with pytest.raises(AssertionError, match="held >"):
                lg.assert_clean(graph, max_hold_ms=1.0)
        out[name] = (cycles, edges, holds if scenario == "hold_tracking" else None)
    assert out["port"] == out["reference"]
    cycles = out["port"][0]
    assert len(cycles) == n_cycles and all(len(c) == 2 for c in cycles)
    assert all(s.startswith("test_torch_fleetlint.py:") for c in cycles for s in c)


def test_lockgraph_sites_read_from_the_port_on():
    from torchft_tpu_torch.serving import SnapshotRegistry

    with p_lockgraph.watch() as graph:
        reg = SnapshotRegistry()
        try:
            assert reg.register("r0")[0] == 200
        finally:
            reg.shutdown()
    sites = set(graph.report()["max_hold_ms"])
    assert any(s.startswith("torchft_tpu_torch/serving.py:") for s in sites), sites
    p_lockgraph.assert_clean(graph)


def test_lockgraph_survives_a_first_import_inside_the_watch():
    """A module imported for the first time inside a watch may hand its
    lock's reinit to ``os.register_at_fork`` (``concurrent.futures.thread``
    does; the reference's wrapper has no ``_at_fork_reinit`` and the import
    fails there): the port's wrapper passes it to the real lock."""
    code = textwrap.dedent("""
        import os
        from torchft_tpu_torch.analysis import lockgraph
        with lockgraph.watch() as graph:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(2) as ex:
                assert list(ex.map(abs, [-1, -2])) == [1, 2]
        pid = os.fork()
        if pid == 0:
            os._exit(0)
        assert os.waitpid(pid, 0)[1] == 0
        lockgraph.assert_clean(graph)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_policy_trainer_crash_and_heal_under_the_detector(tmp_path, monkeypatch):
    """The CPU counterpart of chip_smoke.py's phase 20 under the detector:
    two debug-Llama replica threads with the fp8 ring's workers, the
    lighthouse with its policy controller in enforce mode, replica 1
    crashing after step 3's backward pass and healing over HTTP, all built
    inside ``watch``: no acquisition-order cycle."""
    import torch

    from torchft_tpu_torch.train import Fault, TrainConfig, run_replicas

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "name": "churn-widen-eject",
        "rules": [{"name": "churn-widen-eject", "signal": "churn_per_min", "op": ">",
                   "threshold": 7.5, "release": 0.5,
                   "actions": {"TORCHFT_HEALTH_EJECT_Z": "9.0"}}],
        "clamps": {"TORCHFT_HEALTH_EJECT_Z": [3.0, 12.0]}}))
    for name, value in {"TORCHFT_POLICY": "enforce", "TORCHFT_POLICY_INTERVAL_S": "0.25",
                        "TORCHFT_POLICY_WINDOW_S": "8"}.items():
        monkeypatch.setenv(name, value)
    cfg = TrainConfig(config="debug", seq_len=16, replicas=2, steps=6, quantize=True,
                      transport="http", trace_dir=str(tmp_path), policy=str(spec),
                      faults=(Fault(1, 3, "crash", at="backward"),))
    try:
        with p_lockgraph.watch() as graph:
            results = run_replicas(cfg, torch.device("cpu"))
    finally:
        knobs.clear_overrides()
    assert [r["step"] for r in results] == [6, 6]
    assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
    report = graph.report()
    assert report["locks"] > 50 and report["edges"] > 0, report
    p_lockgraph.assert_clean(graph)


@pytest.mark.parametrize("lg", [r_lockgraph, p_lockgraph], ids=["reference", "port"])
def test_nested_watch_refused(lg):
    with lg.watch():
        with pytest.raises(RuntimeError, match="already active"):
            with lg.watch():
                pass
    with lg.watch():  # released: a later watch starts
        pass


# -------------------------------------------------------------- the port alone
def test_port_has_no_finding_beyond_its_baseline():
    findings = p_core.run_all()
    baseline = p_core.load_baseline()
    new, stale = p_core.diff_baseline(findings, baseline)
    assert new == [], [f.render() for f in new]
    assert stale == []
    assert {f.fingerprint for f in findings} == set(baseline) == {
        "env-contract:undoctored-knob:torchft_tpu_torch/knobs.py:TORCHFT_TPU_ATTENTION"}


def test_baseline_entries_all_justified():
    baseline = p_core.load_baseline()
    assert baseline and p_core.unjustified(baseline) == []
    for fp, why in baseline.items():
        assert len(why.split()) >= 10 and why != "accepted pre-existing finding", fp


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "torchft_tpu_torch.analysis", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_cli_ci_exits_zero_on_the_tree():
    out = _cli("--ci")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith(
        "fleetlint: 1 finding(s), 0 new, 1 baselined (0 stale) [5 checkers, ")


def test_cli_fails_on_new_finding_and_on_unjustified_entry(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"version": 1, "findings": []}))
    out = _cli("--ci", "--baseline", str(empty))
    assert out.returncode == 1 and "TORCHFT_TPU_ATTENTION" in out.stdout
    # --update keeps nothing it was not given a reason for: the entry is
    # written empty, and an empty justification fails the run
    upd = _cli("--update", "--baseline", str(empty), "--checker", "env-contract")
    assert upd.returncode == 0 and "write a justification" in upd.stdout
    entries = json.loads(empty.read_text())["findings"]
    assert [e["justification"] for e in entries] == [""]
    out = _cli("--ci", "--baseline", str(empty), "--checker", "env-contract")
    assert out.returncode == 1 and "without a justification" in out.stdout
    # a stale entry warns and does not fail
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 1, "findings": json.loads(
        p_core.DEFAULT_BASELINE.read_text())["findings"] + [
        {"fingerprint": "stale-guard:missing-stale-guard:x.py:gone", "justification": "a test"}]}))
    out = _cli("--ci", "--baseline", str(stale))
    assert out.returncode == 0 and "WARNING stale baseline entry" in out.stdout


def test_port_docs_are_the_readme_port_section():
    repo = p_core.load_repo()
    assert {"README.md", "README.md#knobs", "README.md#counters", "README.md#fleetlint"} <= set(
        repo.docs)
    for name in knobs.REGISTRY:
        assert name in repo.docs["README.md#knobs"]
    for key in list(p_contracts.DECLARED_TIMINGS) + list(p_contracts.DECLARED_SERIES):
        assert f"`{key}`" in repo.docs["README.md#counters"]
    assert "## Benchmarks" not in repo.docs["README.md"]


def test_a_key_left_out_of_the_counters_table_is_found(tmp_path):
    readme = (REPO / "README.md").read_text()
    cut = readme.replace("`shard_encode_s`", "`shard_encoding_s`")
    assert cut != readme
    (tmp_path / "README.md").write_text(cut)
    findings = p_counter.check(p_core.load_repo(docs_root=tmp_path / "README.md"))
    assert _rules(findings) == {("undocumented-counter", "shard_encode_s")}


def test_port_contract_against_the_reference():
    ref_keys = set(r_counter.DECLARED_TIMINGS)
    port_keys = set(p_contracts.DECLARED_TIMINGS)
    assert port_keys - ref_keys == {"standby_send_s", "reconstruct_shards_ok", "shard_put_s"}
    # the device plane brought allreduce_s; the degrade plane's three wait
    assert ref_keys - port_keys == {"degrade_events", "degraded_reshard_s", "restored_events"}
    assert p_contracts.DECLARED_SERIES == r_counter.DECLARED_SERIES
    assert CHECKER_NAMES == ("env-contract", "counter-contract", "lock-discipline",
                             "blocking-calls", "stale-guard")


@pytest.mark.parametrize("drift", ["none", "missing", "stale"])
def test_doctor_fleetlint_check_agrees_with_the_reference(drift, monkeypatch):
    """ok on the committed baselines; FAIL when the baseline lacks the
    findings; warn when it holds one that no longer fires."""
    for mod in (r_core, p_core):
        load = mod.load_baseline
        if drift == "missing":
            monkeypatch.setattr(mod, "load_baseline", lambda path=None: {})
        elif drift == "stale":
            monkeypatch.setattr(mod, "load_baseline", lambda path=None, load=load: {
                **load(), "env-contract:dead-knob:x.py:TORCHFT_GONE": "a test"})
    port = doctor.run_check(doctor.check_fleetlint)
    ref = ref_doctor.check_fleetlint()
    assert port[0] == ref[0] == {"none": True, "missing": False, "stale": None}[drift], (port, ref)
    if drift == "none":
        assert port[1] == "1 finding(s), all baselined"


def test_the_port_copy_stands_alone():
    """The port's analysis modules are its own copies: none imports the
    reference's, and the checkers import nothing beyond the standard
    library and the port's knobs."""
    for path in (REPO / "torchft_tpu_torch" / "analysis").glob("*.py"):
        text = path.read_text()
        assert "from torchft_tpu." not in text and "import torchft_tpu\n" not in text, path
