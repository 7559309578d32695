"""Llama-3-family transformer as a torch ``nn.Module``.

Counterpart of ``torchft_tpu/models/llama.py``, with the same ``CONFIGS``,
the same parameter names and the same ``[in, out]`` weight layout (so
``x @ w`` as in the reference), one module per layer in place of the
reference's stacked ``[L, ...]`` arrays (``convert.py`` maps between them):

- params and activations in the config's dtype (bf16 by default), RMSNorm
  in f32 (``llama.py:154``);
- GQA attention with NeoX half-rotation RoPE (``:160-168``), SwiGLU MLP,
  pre-norm, untied embedding and head;
- the loss is ``logsumexp(logits) - logits[target]`` (``:255-309``), with
  the ``loss_chunk`` path that recomputes each sequence chunk's logits in
  backward;
- ``remat`` takes the reference's modes ("none", "dots", "attn", "full",
  or the bools; ``models/remat.py``), "dots" by default as the
  reference's ``llama_loss``;
- ``attention_fn(q, k, v, cfg)`` replaces the attention, as the
  reference's ``make_llama_layer_body(cfg, attention_fn)`` (``:181``), and
  ``offset`` starts RoPE's positions (``:160``, ``:192``) at a sequence
  shard's place in the whole sequence.

Inside a replica group (``torchft_tpu_torch/parallel/mesh.py``) the
weights may be DTensors: the layers compute on their local shards (head
counts come from the local widths) and, when ``tp_group`` is set, join
tensor-parallel shards Megatron's way: the input of each column-parallel
block is copied to the tp ranks (its gradient summed over them), the
output of each row-parallel block summed over them (its gradient copied),
and the embedding's and the head's shards gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.models.remat import remat_wrap, resolve_remat
from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.parallel.mesh import llama_param_specs
from torchft_tpu_torch.utils import local_shard, resolve_device

__all__ = ["LlamaConfig", "CONFIGS", "Llama"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, h, v, L = self.dim, self.ffn_hidden, self.vocab_size, self.n_layers
        kv = self.n_kv_heads * self.head_dim
        per_layer = d * d + 2 * d * kv + d * d + 3 * d * h + 2 * d
        return L * per_layer + 2 * v * d + d


CONFIGS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_hidden=128, max_seq_len=128, dtype=torch.float32,
    ),
    "tiny": LlamaConfig(
        vocab_size=2048, dim=256, n_layers=4, n_heads=8, n_kv_heads=4,
        ffn_hidden=688, max_seq_len=1024,
    ),
    "bench_350m": LlamaConfig(
        vocab_size=32000, dim=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        ffn_hidden=2816, max_seq_len=2048,
    ),
    "bench_1b": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=20, n_heads=16, n_kv_heads=8,
        ffn_hidden=5632, max_seq_len=2048,
    ),
    "bench_2b": LlamaConfig(
        vocab_size=32000, dim=2560, n_layers=18, n_heads=20, n_kv_heads=10,
        ffn_hidden=7040, max_seq_len=2048,
    ),
    "llama3_8b": LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_hidden=14336, max_seq_len=8192,
    ),
    "llama3_70b": LlamaConfig(
        vocab_size=128256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        ffn_hidden=28672, max_seq_len=8192,
    ),
}


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def _rope(x: torch.Tensor, theta: float,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NeoX half-rotation rotary embedding; x: [B, S, H, hd], positions [S]
    or [B, S] (default ``arange(S)``)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    if positions is None:
        positions = torch.arange(S, device=x.device)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.dim() == 1:
        pos = pos[None]
    angles = pos[:, :, None, None] * freqs  # [B or 1, S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The partial sums of the tp group added up; the gradient copied."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The tp group's shards of the last dim concatenated in rank order; the
    gradient's own slice kept."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=-1)[r].contiguous(), None


def _tp(fn, x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else fn.apply(x, group)


class AttentionBlock(nn.Module):
    """The attention half of a pre-norm layer and the FFN's norm, which
    every model family shares (``models/moe.py`` adds a sparse FFN)."""

    def __init__(self, cfg: LlamaConfig, attention: Optional[str],
                 attention_fn: Optional[Callable] = None) -> None:
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.attention = attention
        self.attention_fn = attention_fn
        # the tensor-parallel group the weights are split over (None: whole)
        self.tp_group = None
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.wq = self.weight(d, cfg.n_heads * hd)
        self.wk = self.weight(d, cfg.n_kv_heads * hd)
        self.wv = self.weight(d, cfg.n_kv_heads * hd)
        self.wo = self.weight(cfg.n_heads * hd, d)
        self.ffn_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))

    def weight(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.empty(*shape, dtype=self.cfg.dtype))

    def attend(self, h: torch.Tensor, offset: int) -> torch.Tensor:
        """h + the attention block's output; h [B, S, dim] holds the
        sequence positions ``offset`` to ``offset + S``."""
        cfg, tp = self.cfg, self.tp_group
        B, S, hd = h.shape[0], h.shape[1], cfg.head_dim
        wq, wk, wv = local_shard(self.wq), local_shard(self.wk), local_shard(self.wv)
        positions = torch.arange(offset, offset + S, device=h.device)
        x = _tp(_CopyToTP, _rmsnorm(h, local_shard(self.attn_norm), cfg.norm_eps), tp)
        q = _rope((x @ wq).reshape(B, S, wq.shape[1] // hd, hd), cfg.rope_theta, positions)
        k = _rope((x @ wk).reshape(B, S, wk.shape[1] // hd, hd), cfg.rope_theta, positions)
        v = (x @ wv).reshape(B, S, wv.shape[1] // hd, hd)
        if self.attention_fn is not None:
            attn = self.attention_fn(q, k, v, cfg)
        else:
            attn = causal_attention(q, k, v, cfg, impl=self.attention)
        return h + _tp(_ReduceFromTP, attn.reshape(B, S, -1) @ local_shard(self.wo), tp)

    def ffn_input(self, h: torch.Tensor) -> torch.Tensor:
        """The FFN's normed input (its tp gradient not yet summed)."""
        return _rmsnorm(h, local_shard(self.ffn_norm), self.cfg.norm_eps)


class LlamaLayer(AttentionBlock):
    """One pre-norm transformer layer (attention + SwiGLU MLP)."""

    def __init__(self, cfg: LlamaConfig, attention: Optional[str],
                 attention_fn: Optional[Callable] = None) -> None:
        super().__init__(cfg, attention, attention_fn)
        self.w_gate = self.weight(cfg.dim, cfg.ffn_hidden)
        self.w_up = self.weight(cfg.dim, cfg.ffn_hidden)
        self.w_down = self.weight(cfg.ffn_hidden, cfg.dim)

    def forward(self, h: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """h [B, S, dim]: the sequence positions ``offset`` to ``offset + S``."""
        h = self.attend(h, offset)
        x = _tp(_CopyToTP, self.ffn_input(h), self.tp_group)
        gate, up = x @ local_shard(self.w_gate), x @ local_shard(self.w_up)
        mlp = (F.silu(gate) * up) @ local_shard(self.w_down)
        return h + _tp(_ReduceFromTP, mlp, self.tp_group)


class Llama(nn.Module):
    """The Llama model: ``embed`` [V, D], ``layers.{i}.*``, ``final_norm``
    [D], ``lm_head`` [D, V], allocated on ``device`` (``cuda`` unless
    another is given). ``attention`` picks ``causal_attention``'s
    implementation (None: ``TORCHFT_TPU_ATTENTION`` on each call, "auto"
    if unset); ``attention_fn(q, k, v, cfg)``, when given, replaces it
    (``torchft_tpu_torch.parallel``'s sequence-parallel attentions);
    ``remat`` is each layer's rematerialization mode in training
    (``models/remat.py``; "dots" by default, as the reference's
    ``llama_loss``)."""

    layer_cls = LlamaLayer

    def __init__(
        self,
        cfg: LlamaConfig,
        device: "str | torch.device | None" = None,
        attention: Optional[str] = None,
        remat: Any = "dots",
        attention_fn: Optional[Callable] = None,
    ) -> None:
        super().__init__()
        resolve_remat(remat)
        self.cfg = cfg
        self.remat = remat
        self.tp_group = None
        with torch.device(resolve_device(device)):
            self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, dtype=cfg.dtype))
            self.layers = nn.ModuleList(
                self.layer_cls(cfg, attention, attention_fn) for _ in range(cfg.n_layers)
            )
            self.final_norm = nn.Parameter(torch.ones(cfg.dim, dtype=cfg.dtype))
            self.lm_head = nn.Parameter(torch.empty(cfg.dim, cfg.vocab_size, dtype=cfg.dtype))

    def set_tp_group(self, group) -> None:
        """The process group the weights' tensor-parallel shards lie on."""
        self.tp_group = group
        for layer in self.layers:
            layer.tp_group = group

    def param_specs(self) -> Dict[str, Any]:
        """Each parameter's placement over the mesh axes
        (``parallel.apply_hsdp`` reads it)."""
        return llama_param_specs(self.cfg)

    def set_parallel(self, mesh) -> None:
        """Called by ``parallel.apply_hsdp`` with the model's mesh; the dense
        Llama needs no group beyond ``tp``'s."""

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Dense weights ~ N(0, 1/fan_in) drawn in f32, norms at 1 (the
        reference's init; the draws differ from jax.random's). A weight's
        fan-in is its ``in`` dim: ``[in, out]``, or ``[E, in, out]`` for
        stacked experts; the embedding's is its width."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
                continue
            fan_in = p.shape[1] if name == "embed" else p.shape[-2]
            draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            p.copy_(draw / fan_in ** 0.5)

    def hidden(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """tokens int [B, S] (sequence positions ``offset`` on) -> final-norm
        hidden states [B, S, dim]."""
        h = self.embed_tokens(tokens)
        for layer in self.layers:
            h = self.layer_fn(layer)(h, offset)
        return self.final_hidden(h)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return _tp(_GatherFromTP, local_shard(self.embed)[tokens], self.tp_group)

    def layer_fn(self, layer: nn.Module) -> Callable:
        """``layer`` under the model's remat mode when autograd records."""
        return remat_wrap(layer, self.remat) if torch.is_grad_enabled() else layer

    def final_hidden(self, h: torch.Tensor) -> torch.Tensor:
        return _rmsnorm(h, local_shard(self.final_norm), self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """tokens int [B, S] -> logits f32 [B, S, vocab]."""
        return _logits(self.hidden(tokens, offset), local_shard(self.lm_head), self.tp_group)

    def loss(
        self, tokens: torch.Tensor, targets: torch.Tensor, loss_chunk: int = 0,
        offset: int = 0,
    ) -> torch.Tensor:
        """Mean next-token cross-entropy as logsumexp - target logit.
        ``loss_chunk > 0`` computes it over sequence chunks of that length,
        each chunk's logits recomputed in backward, so only [B, chunk,
        vocab] logits are live at once."""
        lm_head = local_shard(self.lm_head)
        if loss_chunk <= 0:
            return _chunk_loss_sum(self.hidden(tokens, offset), lm_head, targets,
                                   self.tp_group) / targets.numel()
        B, S = tokens.shape
        if S % loss_chunk != 0:
            raise ValueError(f"loss_chunk {loss_chunk} must divide seq len {S}")
        h = self.hidden(tokens, offset)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(S // loss_chunk):
            sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
            total = total + checkpoint(
                _chunk_loss_sum, h[:, sl], lm_head, targets[:, sl], self.tp_group,
                use_reentrant=False,
            )
        return total / (B * S)


def _logits(h: torch.Tensor, lm_head: torch.Tensor, tp_group) -> torch.Tensor:
    """f32 logits of the whole vocabulary from the head's (tp) shard."""
    return _tp(_GatherFromTP, _tp(_CopyToTP, h, tp_group) @ lm_head, tp_group).to(torch.float32)


def _chunk_loss_sum(h: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
                    tp_group=None) -> torch.Tensor:
    logits = _logits(h, lm_head, tp_group)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - tgt).sum()
