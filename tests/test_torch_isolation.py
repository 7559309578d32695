"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import torchft_tpu_torch
from torchft_tpu_torch import train
from torchft_tpu_torch.examples import train_llama_hsdp
from torchft_tpu_torch.models.llama import CONFIGS, Llama
from torchft_tpu_torch.models.moe import MOE_CONFIGS, MoE
from torchft_tpu_torch.utils import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            torchft_tpu_torch.__path__, prefix="torchft_tpu_torch."
        )
    )


def test_port_imports_no_jax_and_no_reference_package():
    modules = _port_modules()
    for name in ("manager", "ops.quantization", "local_sgd", "knobs", "examples.train_diloco",
                 "parallel.mesh", "parallel.ring_attention", "parallel.ulysses",
                 "examples.train_llama_hsdp", "models.remat", "models.moe", "tracing", "trace",
                 "flight_recorder", "observability", "healthwatch", "serving",
                 "parameter_server", "checkpointing.durable", "launcher", "aggregator",
                 "examples.punisher", "multiprocessing", "multiprocessing_dummy_context",
                 "doctor", "policy"):
        assert f"torchft_tpu_torch.{name}" in modules
    code = textwrap.dedent(f"""
        import importlib, json, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"))
        print(json.dumps(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(CONFIGS["debug"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_replicas(train.TrainConfig(config="debug"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--config", "debug", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_replicas(train.TrainConfig(config="debug", diloco=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_llama_hsdp.main(["--config", "debug", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoE(MOE_CONFIGS["debug"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_replicas(train.TrainConfig(model="moe", config="debug"))
    assert resolve_device("cpu") == torch.device("cpu")
    assert Llama(CONFIGS["debug"], device="cpu").embed.device.type == "cpu"


def _import_roots(script: str) -> set:
    """Every import in ``script``, at top level or inside a function."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    """Every import in chip_smoke.py, at top level or inside a function."""
    roots = _import_roots("chip_smoke.py")
    assert "torchft_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"}


@pytest.mark.parametrize("script", ["attention_ab.py", "heal_ab.py"])
def test_ab_scripts_import_no_jax_and_no_reference_package(script):
    """The scripts that time two checkouts of the port on the card."""
    roots = _import_roots(script)
    assert "torchft_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"}


@pytest.mark.parametrize("module", ["redundancy", "checkpointing.erasure", "healthwatch",
                                    "observability", "coordination", "manager", "lighthouse",
                                    "train"])
def test_redundancy_plane_imports_no_jax_even_lazily(module):
    """The redundancy plane's modules and the ones it touches: every import,
    at top level or inside a function (``ShardDirectory._poll_health``,
    ``_maybe_promote``, ``LighthouseServer``'s directory), stays in the
    port."""
    roots = _import_roots(os.path.join("torchft_tpu_torch", *module.split(".")) + ".py")
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"}
    assert f"torchft_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", ["tracing", "trace", "flight_recorder", "observability",
                                    "healthwatch", "knobs", "process_group", "policy", "doctor"])
def test_observability_and_health_plane_import_no_jax_even_lazily(module):
    """The health and observability planes: every import, at top level or
    inside a function (``history_replay``'s loader, the OpenTelemetry
    mirror), stays in the port."""
    roots = _import_roots(os.path.join("torchft_tpu_torch", *module.split(".")) + ".py")
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"}
    assert f"torchft_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("path", ["torchft_tpu_torch/serving.py",
                                  "torchft_tpu_torch/parameter_server.py"])
def test_serving_plane_imports_no_jax_even_lazily(path):
    """The serving plane and the parameter server: every import, at top
    level or inside a function (the registry's health poll, the
    transports), stays in the port."""
    roots = _import_roots(path)
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"}


@pytest.mark.parametrize("path", ["torchft_tpu_torch/checkpointing/durable.py",
                                  "torchft_tpu_torch/launcher.py",
                                  "torchft_tpu_torch/aggregator.py",
                                  "torchft_tpu_torch/examples/punisher.py",
                                  "torchft_tpu_torch/examples/train_llama_hsdp.py"])
def test_durable_checkpoints_and_control_plane_import_no_jax_even_lazily(path):
    """Durable checkpoints (DCP, never orbax), the launcher, the pod
    aggregator's CLI, the punisher and the trainer's outage demo: every
    import, at top level or inside a function, stays in the port."""
    roots = _import_roots(path)
    assert not roots & {"jax", "jaxlib", "optax", "ml_dtypes", "orbax", "torchft_tpu"}


_PROBE_PG = """
import sys

import torch

from torchft_tpu_torch.process_group import ProcessGroupHost


class ProbePG(ProcessGroupHost):
    def configure(self, *args, **kwargs):
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"))
        if bad:
            raise RuntimeError(f"the Baby child imported {bad[:5]}")
        if torch.cuda.is_initialized():
            raise RuntimeError("the Baby child initialized CUDA")
        super().configure(*args, **kwargs)
"""

_SPAWN_BABY = """
import multiprocessing as mp

import numpy as np

from probe_pg import ProbePG
from torchft_tpu_torch.coordination import KvStoreServer
from torchft_tpu_torch.process_group import ProcessGroupBabyHost


class ProbeBaby(ProcessGroupBabyHost):
    PG_CLASS = ProbePG


if __name__ == "__main__":
    store = KvStoreServer("127.0.0.1:0")
    pg = ProbeBaby(timeout=30.0)
    pg.configure(f"127.0.0.1:{store.port}/iso", 0, 1, 1)
    out = pg.allreduce([np.arange(4, dtype=np.float32)]).get_future().wait(30)
    assert np.array_equal(out[0], np.arange(4, dtype=np.float32))
    pg.shutdown()
    store.shutdown()
    assert mp.active_children() == []
    print("ok")
"""


def test_spawned_baby_child_imports_no_jax_and_no_cuda(tmp_path):
    """A spawned Baby child unpickles its worker and its process group
    from the port alone: its configure checks that neither JAX nor the
    JAX package was imported and that CUDA was never initialized."""
    (tmp_path / "probe_pg.py").write_text(_PROBE_PG)
    (tmp_path / "spawn_baby.py").write_text(_SPAWN_BABY)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), REPO])
    out = subprocess.run([sys.executable, str(tmp_path / "spawn_baby.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


_LIGHTHOUSE_WITH_POLICY = """
import os, signal, sys, threading, time

from torchft_tpu_torch import lighthouse

servers = []


class Recorded(lighthouse.LighthouseServer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        servers.append(self)


lighthouse.LighthouseServer = Recorded


def watch():
    # the engine's first pass has run once a frame is published
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and not (servers and servers[0].policy()):
        time.sleep(0.05)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "optax", "ml_dtypes", "torchft_tpu"))
    print("frame", servers[0].policy().get("policy_seq"), "bad", bad, flush=True)
    os.kill(os.getpid(), signal.SIGTERM)


threading.Thread(target=watch, daemon=True).start()
lighthouse.main(["--bind", "127.0.0.1:0", "--policy", "builtin"])
"""


def test_the_lighthouse_cli_with_a_policy_imports_no_jax(tmp_path):
    """``python -m torchft_tpu_torch.lighthouse --policy builtin`` under
    ``TORCHFT_POLICY=observe``: once its engine has published a frame, its
    process holds neither JAX nor the JAX package, and it exits 0 on
    SIGTERM."""
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("TORCHFT_")}
    env.update(PYTHONPATH=REPO, TORCHFT_POLICY="observe", TORCHFT_POLICY_INTERVAL_S="0.05")
    (tmp_path / "lh.py").write_text(_LIGHTHOUSE_WITH_POLICY)
    out = subprocess.run([sys.executable, str(tmp_path / "lh.py")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "frame 1 bad []"
    assert "policy engine attached (spec=builtin mode=observe)" in out.stderr
