"""The port's doctor against the JAX package's (``torchft_tpu/doctor.py``):
the same status (ok / warn / FAIL) from each of the 18 checks the port has,
at defaults and under broken environments, the same exit code from both
CLIs, and the knob registry's doctor names all pointing at checks the
port's doctor runs."""

import os
import re
import subprocess
import sys

import pytest

from torchft_tpu import doctor as ref_doctor
from torchft_tpu_torch import doctor, knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [name for name, _ in doctor.CHECKS]
REF = dict(ref_doctor.CHECKS)
PORT = dict(doctor.CHECKS)
# the reference's checks that come with their planes
LATER = {"degrade-env", "fleetlint"}
STATUS = {True: "ok", None: "warn", False: "FAIL"}
LINE = re.compile(r"^(ok  |warn|FAIL) (\S+)\s+(.*)$")


def test_the_port_runs_the_reference_checks_in_its_order():
    assert len(NAMES) == 18
    assert NAMES == [name for name, _ in ref_doctor.CHECKS if name not in LATER]


def test_registry_doctor_names_are_checks_of_the_port():
    """Every knob's doctor names a check the port's doctor has (the policy
    plane's five and TORCHFT_SYNC_EVERY: policy-env)."""
    named = {k.name: k.doctor for k in knobs.REGISTRY.values() if k.doctor is not None}
    missing = {n: d for n, d in named.items() if d not in PORT}
    assert missing == {}
    assert sorted(n for n, d in named.items() if d == "policy-env") == [
        "TORCHFT_POLICY", "TORCHFT_POLICY_INTERVAL_S", "TORCHFT_POLICY_RING",
        "TORCHFT_POLICY_SPEC", "TORCHFT_POLICY_WINDOW_S", "TORCHFT_SYNC_EVERY"]
    assert knobs.REGISTRY["TORCHFT_TPU_ATTENTION"].doctor is None


def _cli(module, env):
    out = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    statuses = {}
    for line in out.stdout.splitlines():
        m = LINE.match(line)
        if m:
            statuses[m.group(2)] = m.group(1).strip()
    return out.returncode, statuses, out.stdout


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TORCHFT_")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("extra, rc", [
    ({}, 0),
    # a retry ceiling above the quorum timeout fails retry-env in both
    ({"TORCHFT_RETRY_MAX_BACKOFF_S": "90", "TORCHFT_QUORUM_TIMEOUT_SEC": "60"}, 1),
], ids=["defaults", "retry_ceiling_over_quorum"])
def test_both_clis_agree_line_by_line_and_by_exit_code(extra, rc):
    env = _clean_env(**extra)
    port_rc, port, text = _cli("torchft_tpu_torch.doctor", env)
    ref_rc, ref, _ = _cli("torchft_tpu.doctor", env)
    assert list(port) == NAMES, text
    assert port == {n: ref[n] for n in NAMES}
    assert port_rc == ref_rc == rc
    # no card here: the accelerator check warns, as the reference's does
    assert port["accelerator"] == "warn"


@pytest.fixture()
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("TORCHFT_"):
            monkeypatch.delenv(name)
    return monkeypatch


# checks that read the environment (a subprocess probe and a loopback
# round trip with explicit settings do not), and heal, whose retry policy
# is its own whatever the environment says
ENV_CHECKS = ["aggregator", "retry-env", "health-env", "compress-env", "serve-env",
              "redundancy-env", "trace-env", "policy-env", "tuning-env"]


def _unwritable(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    return str(blocker / "traces")


SCENARIOS = {
    "retry_ceiling_over_quorum": ({"TORCHFT_RETRY_MAX_BACKOFF_S": "90",
                                   "TORCHFT_QUORUM_TIMEOUT_SEC": "60"}, {"retry-env": "FAIL"}),
    "retry_sleeps_over_quorum": ({"TORCHFT_RETRY_MAX_ATTEMPTS": "40",
                                  "TORCHFT_RETRY_MAX_BACKOFF_S": "5",
                                  "TORCHFT_TIMEOUT_SEC": "60"}, {"retry-env": "warn"}),
    "retries_off": ({"TORCHFT_RETRY_MAX_ATTEMPTS": "1"}, {"retry-env": "warn"}),
    # the aggregator check's loopback lighthouse reads the health knobs too
    "eject_below_warn": ({"TORCHFT_HEALTH_EJECT_Z": "2.0", "TORCHFT_HEALTH_WARN_Z": "3.0"},
                         {"health-env": "FAIL", "aggregator": "FAIL"}),
    "probation_under_heartbeat": ({"TORCHFT_HEALTH_PROBATION_MS": "50",
                                   "TORCHFT_HEARTBEAT_INTERVAL_MS": "100"},
                                  {"health-env": "FAIL"}),
    "unwritable_trace_dir": (_unwritable, {"trace-env": "FAIL"}),
    "trace_buffer_garbage": ({"TORCHFT_TRACE_BUFFER": "lots"}, {"trace-env": "FAIL"}),
    "bucket_cap_typo": ({"TORCHFT_BUCKET_CAP_MB": "32mb"}, {"tuning-env": "FAIL"}),
    "compress_without_streaming": ({"TORCHFT_COMPRESS": "fp8", "TORCHFT_STREAM_BUCKETS": "0"},
                                   {"compress-env": "warn"}),
    "bad_compress": ({"TORCHFT_COMPRESS": "zstd"}, {"compress-env": "FAIL"}),
    "bad_serve_knob": ({"TORCHFT_SERVE_COMPRESS": "zstd"}, {"serve-env": "FAIL"}),
    "bad_redundancy_knob": ({"TORCHFT_REDUNDANCY_K": "two"}, {"redundancy-env": "FAIL"}),
    "redundancy_without_directory": ({"TORCHFT_REDUNDANCY_K": "2"}, {"redundancy-env": "warn"}),
    "malformed_aggregator": ({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "no-port-here",
                              "TORCHFT_LIGHTHOUSE": "127.0.0.1:1"}, {"aggregator": "FAIL"}),
    "aggregator_without_root": ({"TORCHFT_LIGHTHOUSE_AGGREGATOR": "127.0.0.1:29520"},
                                {"aggregator": "FAIL"}),
    # the aggregator check's loopback lighthouse attaches the engine, which
    # refuses the mode
    "bad_policy_mode": ({"TORCHFT_POLICY": "yolo"}, {"policy-env": "FAIL", "aggregator": "FAIL"}),
    "bad_policy_interval": ({"TORCHFT_POLICY_INTERVAL_S": "often"}, {"policy-env": "FAIL"}),
    "policy_enforce": ({"TORCHFT_POLICY": "enforce"}, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_env_checks_agree_with_the_reference(scenario, clean_env, tmp_path):
    env, expect = SCENARIOS[scenario]
    if callable(env):
        env = {"TORCHFT_TRACE_DIR": env(tmp_path)}
    for name, value in env.items():
        clean_env.setenv(name, value)
    checks = ENV_CHECKS + (["heal"] if scenario == "retries_off" else [])
    port = {n: STATUS[doctor.run_check(PORT[n])[0]] for n in checks}
    ref = {}
    for n in checks:
        try:
            ref[n] = STATUS[REF[n]()[0]]
        except Exception:  # noqa: BLE001 - the reference's main counts a raise as FAIL
            ref[n] = "FAIL"
    assert port == ref
    for name, status in expect.items():
        assert port[name] == status, (name, port)
    assert all(s == "ok" for n, s in port.items() if n not in expect), port
