"""Ring attention: sequence parallelism for long sequences.

Counterpart of ``torchft_tpu/parallel/ring_attention.py`` (``:27-96``),
plain torch as the reference is plain ``jnp``: each rank of the ``sp``
group keeps its query shard while the KV shards rotate around the group,
and causal attention accumulates over them by the online softmax in f32.
The rotation is an autograd function that sends to rank ``(i + 1) % P``
and receives from ``(i - 1) % P`` (``batch_isend_irecv``); its backward
rotates the gradient the other way, as JAX's transpose of ``ppermute``
does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["ring_attention", "make_ring_attention_fn", "make_sp_attention_fn"]


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to group rank ``i + shift``, the one of ``i - shift``
    received (ranks mod the group's size)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (i + shift) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - shift) % n), group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -1), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[Any] = None) -> torch.Tensor:
    """Causal ring attention over ``group`` (None: a group of one).

    q: [B, S_loc, Hq, hd]; k/v: [B, S_loc, Hkv, hd]: this rank's sequence
    shard (global position = group rank * S_loc + offset). Returns [B,
    S_loc, Hq, hd] in q's dtype."""
    P = 1 if group is None else dist.get_world_size(group)
    my_idx = 0 if group is None else dist.get_rank(group)
    B, S, Hq, hd = q.shape
    groups = Hq // k.shape[2]
    q32 = q.to(torch.float32)
    q_pos = my_idx * S + torch.arange(S, device=q.device)
    scale = 1.0 / math.sqrt(hd)

    # online softmax accumulators
    m = torch.full((B, Hq, S), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, S, Hq, hd), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(P):
        kv_idx = (my_idx - i) % P
        kv_pos = kv_idx * S + torch.arange(S, device=q.device)
        k_rep = k_blk.repeat_interleave(groups, dim=2).to(torch.float32)
        v_rep = v_blk.repeat_interleave(groups, dim=2).to(torch.float32)
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_rep) * scale
        causal = q_pos[:, None] >= kv_pos[None, :]
        scores = scores.masked_fill(~causal, -math.inf)

        m_new = torch.maximum(m, scores.amax(dim=-1))
        # fully masked rows keep m_new == -inf: a zero surrogate keeps the
        # exps finite (their probabilities are zeroed by the mask)
        m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
        p = torch.where(torch.isneginf(scores), torch.zeros_like(scores),
                        torch.exp(scores - m_safe[..., None]))
        alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1)
        o = alpha.transpose(1, 2)[..., None] * o + torch.einsum("bhqk,bkhd->bqhd", p, v_rep)
        m = m_new
        if i + 1 < P:
            # the next KV shard around the ring
            k_blk, v_blk = _Rotate.apply(k_blk, group), _Rotate.apply(v_blk, group)
    l_t = l.transpose(1, 2)[..., None]  # [B, S, H, 1]
    out = torch.where(l_t > 0, o / l_t.clamp_min(1e-20), torch.zeros_like(o))
    return out.to(q.dtype)


def make_sp_attention_fn(mesh: DeviceMesh, kernel: Callable) -> Callable:
    """The ``attention_fn(q, k, v, cfg)`` of the port's Llama for a
    sequence-parallel strategy: ``kernel(q, k, v, cfg, group)`` on this
    rank's shards, bound to the mesh's ``sp`` group (the reference's
    shared ``shard_map`` wrapper, so ring and Ulysses share one
    contract: rows over ``fsdp``, sequence over ``sp``, heads over
    ``tp``)."""
    sp = mesh["sp"]
    group = sp.get_group() if sp.size() > 1 else None

    def attention_fn(q, k, v, cfg):
        return kernel(q, k, v, cfg, group)

    return attention_fn


def make_ring_attention_fn(mesh: DeviceMesh) -> Callable:
    """Ring attention over the mesh's ``sp`` group as a Llama
    ``attention_fn``."""
    return make_sp_attention_fn(mesh, lambda q, k, v, cfg, group: ring_attention(q, k, v, group))
