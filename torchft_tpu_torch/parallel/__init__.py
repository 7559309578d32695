"""The parallelism inside a replica group: the HSDP mesh and its sharding
rules, and the two sequence-parallel attentions (counterpart of
``torchft_tpu/parallel``; ``pipeline`` and ``degrade`` are not ported
yet)."""

from torchft_tpu_torch.parallel.mesh import (
    apply_hsdp,
    llama_param_specs,
    make_hsdp_mesh,
    make_train_step,
    shard_batch,
)
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention_fn, ring_attention
from torchft_tpu_torch.parallel.ulysses import make_ulysses_attention_fn, ulysses_attention

__all__ = [
    "make_hsdp_mesh",
    "llama_param_specs",
    "shard_batch",
    "apply_hsdp",
    "make_train_step",
    "ring_attention",
    "make_ring_attention_fn",
    "ulysses_attention",
    "make_ulysses_attention_fn",
]
