"""Mixture-of-Experts Llama variant with expert parallelism.

Counterpart of ``torchft_tpu/models/moe.py``: the Llama layer with its FFN
replaced by a router and ``num_experts`` SwiGLU experts, GShard top-k
routing with a per-expert capacity, and the Switch load-balancing loss.
The port keeps the reference's math and parameter names, one module per
layer (``convert.moe_params_from_jax`` maps the stacked ``[L, E, ...]``
trees onto them):

- **Static shapes.** Every expert processes exactly ``capacity(T)`` token
  slots a step. Dispatch is a scatter-add (``index_add``) of each token
  into its slot of the ``[E * C, d]`` buffer, combine a gather back;
  tokens past an expert's capacity are parked on a slot with weight zero
  and fall through on the residual. The parked addends are exact zeros,
  so the CUDA atomics of ``index_add`` leave every slot's sum exact.
- **Router in f32** (the probabilities and queue positions need it), the
  expert products batched (``torch.bmm``) in the model's dtype, outside
  any kernel, as the reference computes them.
- **Expert parallelism over ``ep``** (``moe_param_specs``, applied by
  ``parallel.apply_hsdp``): each ``ep`` rank holds ``E / ep`` experts
  and runs their slots; tokens stay replicated over ``ep`` (the
  reference's batch spec is ``(dp, fsdp)``), and the partial combine is
  summed over ``ep`` (all-reduce forward, identity backward). Within an
  expert, dims ride ``fsdp`` and ``tp`` as the reference's table.
- **Routing is global.** The reference routes the whole step's batch under
  one ``jit``: the capacity, the queue positions (flat token order
  ``b * S + s``) and the aux loss's means span every token. With the batch
  split over ``fsdp`` (and ``sp``), each rank gathers every rank's top-k
  choices, computes the positions of the global batch (integer work on
  ``T x E``) and keeps its own rows; the mean router probability is summed
  over the ranks. So drops and the aux loss are the reference's.
- Attention, norms and RoPE are the dense Llama's blocks (``causal_attention``,
  K1 on the card), and each layer runs under ``remat_wrap`` ("full" by
  default, as the reference's ``moe_forward``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from torchft_tpu_torch.models.llama import (
    AttentionBlock,
    Llama,
    LlamaConfig,
    _chunk_loss_sum,
    _CopyToTP,
    _logits,
    _ReduceFromTP,
    _tp,
)
from torchft_tpu_torch.parallel.mesh import fsdp_mesh, llama_param_specs
from torchft_tpu_torch.utils import local_shard

__all__ = ["MoEConfig", "MOE_CONFIGS", "MoE", "MoELayer", "RouteGroup", "moe_ffn",
           "moe_param_specs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def capacity(self, tokens: int) -> int:
        """Slots per expert for a batch of ``tokens`` (static given shapes)."""
        c = int(self.capacity_factor * tokens * self.top_k / self.num_experts)
        return max(c, self.top_k)

    def num_params(self) -> int:
        d, h, v, L, E = self.dim, self.ffn_hidden, self.vocab_size, self.n_layers, self.num_experts
        kv = self.n_kv_heads * self.head_dim
        per_layer = d * d + 2 * d * kv + d * d + 3 * E * d * h + d * E + 2 * d
        return L * per_layer + 2 * v * d + d


MOE_CONFIGS: Dict[str, MoEConfig] = {
    "debug": MoEConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_hidden=128, max_seq_len=128, dtype=torch.float32,
        num_experts=4, top_k=2,
    ),
    # ~8x330M sparse params, dense-420M compute class
    "bench_moe": MoEConfig(
        vocab_size=32000, dim=1024, n_layers=24, n_heads=16, n_kv_heads=8,
        ffn_hidden=2816, max_seq_len=2048, num_experts=8, top_k=2,
    ),
}


# [E, d, H] (w_gate, w_up) and [E, H, d] (w_down) experts, and the [d, E]
# router: the reference's P(None, "ep", "fsdp", "tp"), P(None, "ep", "tp",
# "fsdp") and P(None, "fsdp", None) without the layer dim
_EXPERT_COLUMN = {"ep": Shard(0), "fsdp": Shard(1), "tp": Shard(2)}
_EXPERT_ROW = {"ep": Shard(0), "fsdp": Shard(2), "tp": Shard(1)}
_ROUTER = {"fsdp": Shard(0), "tp": Replicate()}


def moe_param_specs(cfg: Any = None) -> Dict[str, Any]:
    """The reference's ``moe_param_specs`` as placements: the Llama's table
    for the dense blocks, ``ep`` on the experts' leading dim."""
    specs = llama_param_specs(cfg)
    specs["layers"] = {**specs["layers"], "router": _ROUTER, "w_gate": _EXPERT_COLUMN,
                       "w_up": _EXPERT_COLUMN, "w_down": _EXPERT_ROW}
    return specs


@dataclasses.dataclass(frozen=True)
class RouteGroup:
    """The ranks a step's batch is split over (``fsdp`` x ``sp``): their
    process group and, per group rank, the (batch-row shard, sequence
    shard) it holds. Routing spans all of them."""

    group: Any
    coords: Tuple[Tuple[int, int], ...]

    def rows(self) -> int:
        return 1 + max(i for i, _ in self.coords)

    def cols(self) -> int:
        return 1 + max(j for _, j in self.coords)


class _SumOverRanks(torch.autograd.Function):
    """A sum over the group in both directions: each rank's loss reads the
    global sum, so each rank's gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _top_k(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``top_k`` largest probabilities per token, normalized, and their
    experts; ties go to the lower expert index, as ``lax.top_k`` breaks
    them (a stable descending sort)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gates = probs.gather(-1, idx)
    return gates / (gates.sum(dim=-1, keepdim=True) + 1e-9), idx


def _queue_positions(idx: torch.Tensor, num_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token-slot's position in its expert's queue and whether it fits:
    slot 0 before slot 1, earlier tokens before later ones."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=idx.device)
    pos_cols = []
    for j in range(idx.shape[1]):
        mask = F.one_hot(idx[:, j], num_experts)  # [T, E]
        pos = torch.cumsum(mask, dim=0) - 1 + counts[None, :]
        counts = counts + mask.sum(dim=0)
        pos_cols.append((pos * mask).sum(dim=-1))
    pos = torch.stack(pos_cols, dim=1)
    return pos, pos < capacity


def _aux_loss(idx0: torch.Tensor, mean_probs: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch's load-balancing loss E * sum_e f_e * P_e from the first
    choices of every token and the mean router probability."""
    f = F.one_hot(idx0, num_experts).to(torch.float32).mean(dim=0)
    return num_experts * (f * mean_probs).sum()


def _route(probs: torch.Tensor, top_k: int, capacity: int):
    """GShard top-k routing of one batch: (gates [T, k] f32, idx [T, k],
    pos [T, k] queue positions, within [T, k] bool, aux loss): the
    reference's ``_route``."""
    gates, idx = _top_k(probs, top_k)
    pos, within = _queue_positions(idx, probs.shape[1], capacity)
    return gates, idx, pos, within, _aux_loss(idx[:, 0], probs.mean(dim=0), probs.shape[1])


def _top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Dense [T, E, C] combine and dispatch tensors from ``_route`` (the
    reference's test form; the model scatters and gathers)."""
    T, E = probs.shape
    gates, idx, pos, within, aux = _route(probs, top_k, capacity)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=probs.device)
    for j in range(top_k):
        combine = combine + (
            gates[:, j, None, None]
            * within[:, j].to(torch.float32)[:, None, None]
            * F.one_hot(idx[:, j], E).to(torch.float32)[:, :, None]
            * F.one_hot(pos[:, j].clamp(max=capacity - 1), capacity).to(torch.float32)[:, None, :]
        )
    return combine, (combine > 0).to(torch.float32), aux


def _global_route(probs: torch.Tensor, top_k: int, cfg: MoEConfig, shape: Tuple[int, int],
                  route: Optional[RouteGroup]):
    """Routing of this rank's tokens (``shape`` = its [B, S]) as the
    reference routes the whole batch: (gates, idx, pos, within, aux,
    the share of the batch's token-slots dropped)."""
    E = cfg.num_experts
    gates, idx = _top_k(probs, top_k)
    if route is None:
        all_idx, mean_probs = idx, probs.mean(dim=0)
        rows = None
    else:
        B, S = shape
        parts = [torch.empty_like(idx) for _ in route.coords]
        dist.all_gather(parts, idx.contiguous(), group=route.group)
        n_b, n_s = route.rows(), route.cols()
        whole = idx.new_empty((n_b * B, n_s * S, top_k))
        for (i, j), part in zip(route.coords, parts):
            whole[i * B:(i + 1) * B, j * S:(j + 1) * S] = part.reshape(B, S, top_k)
        all_idx = whole.reshape(-1, top_k)
        i, j = route.coords[dist.get_rank(route.group)]
        b = torch.arange(i * B, (i + 1) * B, device=idx.device)
        s = torch.arange(j * S, (j + 1) * S, device=idx.device)
        rows = (b[:, None] * (n_s * S) + s[None, :]).reshape(-1)
        mean_probs = _SumOverRanks.apply(probs.sum(dim=0), route.group) / all_idx.shape[0]
    capacity = cfg.capacity(all_idx.shape[0])
    pos, within = _queue_positions(all_idx, E, capacity)
    dropped = 1.0 - within.to(torch.float32).mean()
    aux = _aux_loss(all_idx[:, 0], mean_probs, E)
    if rows is not None:
        pos, within = pos[rows], within[rows]
    return gates, idx, pos, within, aux, dropped, capacity


def moe_ffn(
    x: torch.Tensor,
    router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    cfg: MoEConfig,
    tp_group=None,
    ep_group=None,
    route: Optional[RouteGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse SwiGLU FFN. x: [B, S, d] -> ([B, S, d], aux loss, dropped
    share). ``w_gate``/``w_up`` [E_local, d, H], ``w_down`` [E_local, H, d]
    hold this ``ep`` rank's experts (all of them without ``ep_group``),
    their H dim this rank's ``tp`` shard."""
    B, S, d = x.shape
    T = B * S
    flat = x.reshape(T, d)
    probs = torch.softmax(flat.to(torch.float32) @ router, dim=-1)  # [T, E]
    gates, idx, pos, within, aux, dropped, C = _global_route(
        probs, cfg.top_k, cfg, (B, S), route)

    E_loc = w_gate.shape[0]
    e0 = 0 if ep_group is None else dist.get_rank(ep_group) * E_loc
    local = (idx >= e0) & (idx < e0 + E_loc)
    # slot in the flattened [E_local * C] queue; a token past its expert's
    # capacity, or routed to another ep rank's expert, is parked on a slot
    # with weight zero
    slots = torch.where(local, (idx - e0) * C + pos.clamp(max=C - 1), 0)
    keep = (within & local).to(x.dtype)  # [T, k]

    xe = _tp(_CopyToTP, _tp(_CopyToTP, flat, tp_group), ep_group)
    buf = torch.zeros((E_loc * C, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        buf = buf.index_add(0, slots[:, j], xe * keep[:, j, None])
    expert_in = buf.reshape(E_loc, C, d)
    h = F.silu(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
    expert_out = torch.bmm(h, w_down).reshape(E_loc * C, d)

    # the gates' gradient is partial where the combine is: summed back
    g = _tp(_CopyToTP, _tp(_CopyToTP, gates, tp_group), ep_group)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        w = (g[:, j].to(x.dtype) * keep[:, j])[:, None]
        out = out + expert_out[slots[:, j]] * w
    out = _tp(_ReduceFromTP, _tp(_ReduceFromTP, out, tp_group), ep_group)
    return out.reshape(B, S, d), aux, dropped


class MoELayer(AttentionBlock):
    """One pre-norm layer: attention, then the router and the experts
    (``router`` [d, E] f32, ``w_gate``/``w_up`` [E, d, H], ``w_down``
    [E, H, d])."""

    def __init__(self, cfg: MoEConfig, attention: Optional[str],
                 attention_fn: Optional[Callable] = None) -> None:
        super().__init__(cfg, attention, attention_fn)
        E, d, H = cfg.num_experts, cfg.dim, cfg.ffn_hidden
        self.router = nn.Parameter(torch.empty(d, E, dtype=torch.float32))
        self.w_gate = self.weight(E, d, H)
        self.w_up = self.weight(E, d, H)
        self.w_down = self.weight(E, H, d)
        # set by parallel/mesh.py for an ep > 1 or split-batch layout
        self.ep_group = None
        self.route: Optional[RouteGroup] = None

    def forward(self, h: torch.Tensor, offset: int = 0):
        """h [B, S, dim] -> (h, aux loss, dropped share)."""
        h = self.attend(h, offset)
        out, aux, dropped = moe_ffn(
            self.ffn_input(h), local_shard(self.router), local_shard(self.w_gate),
            local_shard(self.w_up), local_shard(self.w_down), self.cfg,
            tp_group=self.tp_group, ep_group=self.ep_group, route=self.route)
        return h + out, aux, dropped


class MoE(Llama):
    """The MoE model: the Llama's ``embed``, ``final_norm`` and
    ``lm_head``, with ``MoELayer``s. ``forward`` returns (logits, aux
    loss); ``loss`` is the cross-entropy plus ``aux_loss_weight`` times the
    aux loss. ``remat`` defaults to "full", as the reference's
    ``moe_forward``. After each ``forward`` or ``loss``, ``last_aux`` and
    ``last_dropped`` hold the step's mean aux loss and share of token-slots
    dropped over the layers (detached)."""

    layer_cls = MoELayer

    def __init__(
        self,
        cfg: MoEConfig,
        device: "str | torch.device | None" = None,
        attention: Optional[str] = None,
        remat: Any = "full",
        attention_fn: Optional[Callable] = None,
    ) -> None:
        super().__init__(cfg, device=device, attention=attention, remat=remat,
                         attention_fn=attention_fn)
        self.last_aux: Optional[torch.Tensor] = None
        self.last_dropped: Optional[torch.Tensor] = None

    def param_specs(self) -> Dict[str, Any]:
        return moe_param_specs(self.cfg)

    def set_parallel(self, mesh) -> None:
        """Called by ``parallel.apply_hsdp``: the ``ep`` group the experts
        are split over (None at ep 1) and, when the batch is split over
        ``fsdp`` x ``sp``, those ranks and their shards, which route
        together."""
        ep_mesh, dp_mesh = mesh["ep"], fsdp_mesh(mesh)
        route = None
        if dp_mesh.size() > 1:
            coords = [None] * dp_mesh.size()
            dist.all_gather_object(
                coords, (mesh.get_local_rank("fsdp"), mesh.get_local_rank("sp")),
                group=dp_mesh.get_group())
            route = RouteGroup(dp_mesh.get_group(), tuple(coords))
        for layer in self.layers:
            layer.ep_group = ep_mesh.get_group() if ep_mesh.size() > 1 else None
            layer.route = route

    def moe_hidden(self, tokens: torch.Tensor, offset: int = 0):
        """tokens int [B, S] -> (final-norm hidden states, mean aux loss)."""
        h = self.embed_tokens(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        dropped: List[torch.Tensor] = []
        for layer in self.layers:
            h, layer_aux, layer_dropped = self.layer_fn(layer)(h, offset)
            aux = aux + layer_aux
            dropped.append(layer_dropped.detach())
        aux = aux / self.cfg.n_layers
        self.last_aux = aux.detach()
        self.last_dropped = torch.stack(dropped).mean()
        return self.final_hidden(h), aux

    def hidden(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        return self.moe_hidden(tokens, offset)[0]

    def forward(self, tokens: torch.Tensor, offset: int = 0):
        """tokens int [B, S] -> (logits f32 [B, S, vocab], mean aux loss)."""
        h, aux = self.moe_hidden(tokens, offset)
        return _logits(h, local_shard(self.lm_head), self.tp_group), aux

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, loss_chunk: int = 0,
             offset: int = 0) -> torch.Tensor:
        """Mean next-token cross-entropy (logsumexp form) plus
        ``aux_loss_weight`` times the mean aux loss."""
        if loss_chunk > 0:
            raise ValueError("the MoE loss has no loss_chunk path (the reference's has none)")
        h, aux = self.moe_hidden(tokens, offset)
        ce = _chunk_loss_sum(h, local_shard(self.lm_head), targets, self.tp_group) / targets.numel()
        return ce + self.cfg.aux_loss_weight * aux

