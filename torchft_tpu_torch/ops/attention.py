"""Causal GQA attention for the Llama trainer.

Counterpart of ``torchft_tpu/ops/attention.py``. Layout: q [B, S, Hq, hd],
k/v [B, S, Hkv, hd] (Hq a multiple of Hkv), causal, scaled by 1/sqrt(hd);
output [B, S, Hq, hd].

``causal_attention`` dispatches like the reference: ``"xla"`` is the
materialized path (f32 scores and softmax, repeated K/V), the counterpart
of ``xla_attention``. ``"splash"`` (GQA) and ``"flash"`` (MHA), and
``"auto"`` on a CUDA device, name the fused kernels K1/K2 of ROADMAP.md
queue 2, which are not ported yet: they raise rather than fall back. On
CPU tensors ``"auto"`` resolves to ``"xla"``, as the reference does off
the TPU.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

__all__ = ["causal_attention", "xla_attention", "LAST_DISPATCH"]

# which implementation the last causal_attention call resolved to
LAST_DISPATCH: Optional[str] = None


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    groups = q.shape[2] // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    return k, v


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None) -> torch.Tensor:
    """Materialized causal GQA attention: f32 scores, causal mask, f32
    softmax, probabilities cast back to the input dtype."""
    hd = q.shape[-1]
    k, v = _repeat_kv(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    S = q.shape[1]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch to ``impl`` ("auto" | "xla" | "splash" | "flash")."""
    global LAST_DISPATCH
    if impl not in ("auto", "xla", "splash", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "xla" or (impl == "auto" and not q.is_cuda):
        LAST_DISPATCH = "xla"
        return xla_attention(q, k, v, cfg)
    if impl == "auto":
        impl = "splash" if q.shape[2] != k.shape[2] else "flash"
    raise NotImplementedError(
        f"{impl} attention is the fused kernel "
        f"{'K1' if impl == 'splash' else 'K2'} of ROADMAP.md queue 2, not "
        "ported yet; pass impl='xla' for the materialized path"
    )
