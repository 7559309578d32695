"""Weight conversion from the JAX package's parameter trees.

The reference's Llama keeps per-layer weights stacked along a leading
``[L, ...]`` axis (``torchft_tpu/models/llama.py:llama_init``); the port's
``Llama`` holds one module per layer with the same names and ``[in, out]``
layout. The ``examples/train_ddp.py`` CNN keeps the reference's layouts in
the port (``conv`` HWIO, ``w1`` over the NHWC flatten), so its parameters,
and the momentum of its ``optax.sgd(lr, momentum=0.9)`` state (the trace
of the chain's ``TraceState``), carry over as they are. So do the
``examples/train_diloco.py`` MLP's ``{"layer{i}": {"w", "b"}}`` weights,
as the port MLP's ``layer{i}.w`` / ``layer{i}.b``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["cnn_momentum_from_jax", "cnn_params_from_jax", "llama_params_from_jax",
           "mlp_params_from_jax"]


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


def cnn_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"conv", "w1", "w2"}`` of the reference CNN -> the port CNN's
    state dict (the same names, shapes and layouts)."""
    return {k: _tensor(np.asarray(params[k])) for k in ("conv", "w1", "w2")}


def cnn_momentum_from_jax(opt_state: Any) -> Dict[str, torch.Tensor]:
    """The momentum of an ``optax.sgd(lr, momentum=...)`` state (a chain
    whose first state carries ``trace``) -> ``{name: buffer}``, the port's
    ``torch.optim.SGD`` ``momentum_buffer`` of each parameter."""
    states = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for st in states:
        trace = getattr(st, "trace", None)
        if trace is not None:
            return cnn_params_from_jax(trace)
    raise ValueError("optimizer state carries no momentum trace")


def mlp_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"layer{i}": {"w": [in, out], "b": [out]}}`` of the reference MLP
    -> the port MLP's state dict (``layer{i}.w``, ``layer{i}.b``)."""
    return {f"{layer}.{name}": _tensor(np.asarray(leaf))
            for layer, leaves in params.items() for name, leaf in leaves.items()}
