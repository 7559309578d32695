"""Weight conversion from the JAX package's Llama parameter tree.

The reference keeps per-layer weights stacked along a leading ``[L, ...]``
axis (``torchft_tpu/models/llama.py:llama_init``); the port's ``Llama``
holds one module per layer with the same names and ``[in, out]`` layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["llama_params_from_jax"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # bf16 has no numpy dtype of its own: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def llama_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"embed", "layers": {name: [L, ...]}, "final_norm", "lm_head"}`` of
    host arrays -> a state dict for ``Llama.load_state_dict``."""
    out = {k: _tensor(tree[k]) for k in ("embed", "final_norm", "lm_head")}
    for name, stacked in tree["layers"].items():
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{name}"] = _tensor(stacked[i])
    return out
