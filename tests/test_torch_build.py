"""How the port's kernels are built and how a refused launch reads, on the
CPU (no nvcc is run)."""

import pytest

from torchft_tpu_torch.ops import _build
from torchft_tpu_torch.ops import attention as ta


def test_library_name_follows_the_source_and_the_shared_headers(monkeypatch, tmp_path):
    """An edited kernel source or csrc/*.cuh header gives another library
    name, so the next use rebuilds instead of loading a stale library."""
    (tmp_path / "k.cu").write_text('#include "pieces.cuh"\n')
    (tmp_path / "pieces.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    first = _build._target("k.cu")
    assert first == _build._target("k.cu")
    (tmp_path / "pieces.cuh").write_text("// v2\n")
    second = _build._target("k.cu")
    (tmp_path / "k.cu").write_text('#include "pieces.cuh"\n// edited\n')
    third = _build._target("k.cu")
    assert len({first, second, third}) == 3
    assert all(name.endswith(".so") and "libk-" in name for name in (first, second, third))


@pytest.mark.parametrize("status,words", [
    (-1, "head dim"), (-2, "cuTensorMapEncodeTiled"), (-3, "refused a tile map"),
    (700, "CUDA error 700"),
])
def test_a_refused_launch_raises_and_is_not_counted(status, words):
    ta.reset_launches()
    with pytest.raises(RuntimeError, match=words):
        ta._launch(status, "splash_fwd")
    assert not any(ta.LAUNCHES.values())
    ta._launch(0, "splash_fwd")
    assert ta.LAUNCHES["splash_fwd"] == 1
    ta.reset_launches()
