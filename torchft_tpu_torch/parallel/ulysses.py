"""Ulysses sequence parallelism: all-to-all over the ``sp`` group.

Counterpart of ``torchft_tpu/parallel/ulysses.py`` (``:43-87``). Each rank
trades its sequence shard of every head for the whole sequence of a
subset of the heads (one all-to-all), runs ordinary causal attention on
it (``ops.attention.causal_attention``: the hand-written Hopper kernels
on the card), and trades back (the inverse all-to-all). The all-to-alls
are ``all_to_all_single_autograd``, whose backward is the inverse
exchange. ``sp`` must divide the per-rank head counts (after ``tp``);
ring attention has no such limit.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import all_to_all_single_autograd
from torch.distributed.device_mesh import DeviceMesh

from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.parallel.ring_attention import make_sp_attention_fn

__all__ = ["ulysses_attention", "make_ulysses_attention_fn"]


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of ``x`` [sp, ...]: slice j goes to group rank j, and
    slice i of the result came from group rank i."""
    return all_to_all_single_autograd(x.contiguous(), None, None, group).view(x.shape)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: Any = None,
                      group: Optional[Any] = None) -> torch.Tensor:
    """q: [B, S_loc, Hq, hd]; k/v: [B, S_loc, Hkv, hd] (this rank's sequence
    shard of the ``group``, None for a group of one). Returns [B, S_loc,
    Hq, hd]."""
    sp = 1 if group is None else dist.get_world_size(group)
    if sp == 1:
        return causal_attention(q, k, v, cfg)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % sp or hkv % sp:
        raise ValueError(
            f"ulysses needs sp={sp} to divide the per-device head counts "
            f"(q heads {hq}, kv heads {hkv}); use ring attention for this "
            "config"
        )

    def gather_sequence(x: torch.Tensor) -> torch.Tensor:
        # head-scatter / sequence-gather: [B, S_loc, H, hd] -> [B, S, H/sp, hd]
        B, S, H, D = x.shape
        y = _exchange(x.reshape(B, S, sp, H // sp, D).permute(2, 0, 1, 3, 4), group)
        return y.permute(1, 0, 2, 3, 4).reshape(B, sp * S, H // sp, D)

    out = causal_attention(gather_sequence(q), gather_sequence(k), gather_sequence(v), cfg)
    # the inverse: sequence-scatter / head-gather
    B, S, H, D = out.shape
    y = _exchange(out.reshape(B, sp, S // sp, H, D).permute(1, 0, 2, 3, 4), group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, S // sp, sp * H, D)


def make_ulysses_attention_fn(mesh: DeviceMesh) -> Callable:
    """Ulysses over the mesh's ``sp`` group as a Llama ``attention_fn``:
    the sharding contract of ``make_ring_attention_fn``, and ``sp`` must
    divide the per-rank head counts."""
    return make_sp_attention_fn(mesh, ulysses_attention)
