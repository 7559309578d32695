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
- ``remat=True`` checkpoints each layer, the counterpart of ``remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.ops.attention import causal_attention
from torchft_tpu_torch.utils import resolve_device

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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX half-rotation rotary embedding; x: [B, S, H, hd]."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    pos = torch.arange(S, dtype=torch.float32, device=x.device)
    angles = pos[None, :, None, None] * freqs  # [1, S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaLayer(nn.Module):
    """One pre-norm transformer layer (attention + SwiGLU MLP)."""

    def __init__(self, cfg: LlamaConfig, attention: Optional[str]) -> None:
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        kvd = cfg.n_kv_heads * hd

        def w(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.empty(*shape, dtype=cfg.dtype))

        self.cfg = cfg
        self.attention = attention
        self.attn_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.wq = w(d, cfg.n_heads * hd)
        self.wk = w(d, kvd)
        self.wv = w(d, kvd)
        self.wo = w(cfg.n_heads * hd, d)
        self.ffn_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.w_gate = w(d, cfg.ffn_hidden)
        self.w_up = w(d, cfg.ffn_hidden)
        self.w_down = w(cfg.ffn_hidden, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S = h.shape[0], h.shape[1]
        x = _rmsnorm(h, self.attn_norm, cfg.norm_eps)
        q = (x @ self.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = (x @ self.wk).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = (x @ self.wv).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        attn = causal_attention(q, k, v, cfg, impl=self.attention)
        h = h + attn.reshape(B, S, cfg.n_heads * cfg.head_dim) @ self.wo
        x = _rmsnorm(h, self.ffn_norm, cfg.norm_eps)
        return h + (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class Llama(nn.Module):
    """The Llama model: ``embed`` [V, D], ``layers.{i}.*``, ``final_norm``
    [D], ``lm_head`` [D, V], allocated on ``device`` (``cuda`` unless
    another is given). ``attention`` picks ``causal_attention``'s
    implementation (None: ``TORCHFT_TPU_ATTENTION`` on each call, "auto"
    if unset); ``remat`` checkpoints each layer in training."""

    def __init__(
        self,
        cfg: LlamaConfig,
        device: "str | torch.device | None" = None,
        attention: Optional[str] = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        with torch.device(resolve_device(device)):
            self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, dtype=cfg.dtype))
            self.layers = nn.ModuleList(
                LlamaLayer(cfg, attention) for _ in range(cfg.n_layers)
            )
            self.final_norm = nn.Parameter(torch.ones(cfg.dim, dtype=cfg.dtype))
            self.lm_head = nn.Parameter(torch.empty(cfg.dim, cfg.vocab_size, dtype=cfg.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Dense weights ~ N(0, 1/fan_in) drawn in f32, norms at 1 (the
        reference's init; the draws differ from jax.random's)."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
                continue
            fan_in = p.shape[1] if name == "embed" else p.shape[0]
            draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            p.copy_(draw / fan_in ** 0.5)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens int [B, S] -> final-norm hidden states [B, S, dim]."""
        h = self.embed[tokens]
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, use_reentrant=False)
            else:
                h = layer(h)
        return _rmsnorm(h, self.final_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens int [B, S] -> logits f32 [B, S, vocab]."""
        return (self.hidden(tokens) @ self.lm_head).to(torch.float32)

    def loss(
        self, tokens: torch.Tensor, targets: torch.Tensor, loss_chunk: int = 0
    ) -> torch.Tensor:
        """Mean next-token cross-entropy as logsumexp - target logit.
        ``loss_chunk > 0`` computes it over sequence chunks of that length,
        each chunk's logits recomputed in backward, so only [B, chunk,
        vocab] logits are live at once."""
        if loss_chunk <= 0:
            return _chunk_loss_sum(self.hidden(tokens), self.lm_head, targets) / targets.numel()
        B, S = tokens.shape
        if S % loss_chunk != 0:
            raise ValueError(f"loss_chunk {loss_chunk} must divide seq len {S}")
        h = self.hidden(tokens)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(S // loss_chunk):
            sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
            total = total + checkpoint(
                _chunk_loss_sum, h[:, sl], self.lm_head, targets[:, sl],
                use_reentrant=False,
            )
        return total / (B * S)


def _chunk_loss_sum(h: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits = (h @ lm_head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - tgt).sum()
