"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import torchft_tpu_torch
from torchft_tpu_torch import train
from torchft_tpu_torch.models.llama import CONFIGS, Llama
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
    assert "torchft_tpu_torch.manager" in modules
    assert "torchft_tpu_torch.ops.quantization" in modules
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
    assert resolve_device("cpu") == torch.device("cpu")
    assert Llama(CONFIGS["debug"], device="cpu").embed.device.type == "cpu"
