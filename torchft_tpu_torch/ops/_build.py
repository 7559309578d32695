"""Build and bind the port's hand-written CUDA kernels.

A source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into the
git-ignored ``torchft_tpu_torch/_build/`` (the file name carries a hash of
the source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header rebuilds), and loaded with ctypes. ptxas reports each
kernel's registers, shared memory and spills; the report is kept beside
the library (``build_log``). A file lock per source makes concurrent processes build it once
while different sources build in parallel. Nothing is downloaded; nothing
is built when a module is imported.

No PyTorch headers are compiled (the kernels take raw pointers and a
stream), which keeps a build at seconds instead of the minutes
``torch.utils.cpp_extension`` needs.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

__all__ = ["build", "build_log", "load_library"]

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_OPS_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_OPS_DIR), "_build")
# the -a target: wgmma/setmaxnreg exist only there, and the kernels are
# tuned for Hopper; no fast-math, so divides and denormals stay IEEE
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_CSRC, source), *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(_BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Path of the library of ``csrc/<source>``, compiled first (under the
    build lock) if it is missing."""
    target = _target(source)
    if os.path.exists(target):
        return target
    import fcntl

    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, f".{os.path.basename(target)}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(target):
                tmp = f"{target}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                )
                output = proc.stdout.decode(errors="replace")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {source}:\n{output}")
                with open(_log_path(target), "w") as f:
                    f.write(output)
                os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _log_path(target: str) -> str:
    return os.path.splitext(target)[0] + ".log"


def build_log(source: str) -> str:
    """What nvcc and ptxas printed when the library of ``csrc/<source>``
    was built (registers, shared memory and spills per kernel)."""
    with open(_log_path(build(source))) as f:
        return f.read()


def load_library(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built first if needed. Callers
    cache it."""
    return ctypes.CDLL(build(source))
