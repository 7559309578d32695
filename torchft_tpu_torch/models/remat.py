"""The rematerialization modes shared by every model family (Llama, MoE).

Counterpart of ``torchft_tpu/models/remat.py``: one policy module, so the
remat semantics cannot diverge between the families. Modes are "none",
"dots", "attn" and "full" (``False`` and ``True`` are aliases of "none" and
"full"); anything else raises ``ValueError``, as the reference does.

The trade is device memory against backward-pass work:

- "full": non-reentrant ``torch.utils.checkpoint`` over the layer. It
  saves only the layer's input and recomputes the whole layer forward in
  backward, the attention forward included (~+33% step FLOPs). The
  conservative choice for models and sequences at the edge of memory.
- "dots": saves every product without batch dims (``aten.mm`` and
  ``aten.addmm``: the reference's ``dots_with_no_batch_dims_saveable``)
  plus the attention output (``ATTN_OUT_NAME``). Without the name the
  attention, an operator whose output is not a product, would be
  recomputed in backward. Batched products (``aten.bmm``, the MoE expert
  einsums) are recomputed, as in the reference. Near no-remat backward
  work at a fraction of no-remat activation memory.
- "attn": saves only the attention output; every plain product is
  recomputed in backward. The attention forward is the one block whose
  recompute is disproportionately expensive, while the dense products
  recompute from residuals already in memory, so this keeps nearly
  full-remat's footprint without the most expensive part of its
  recompute.
- "none": autograd saves every residual.

PyTorch has no ``checkpoint_name``: a selective-checkpoint policy
(``create_selective_checkpoint_contexts``) sees operators of the
dispatcher. So the attention output is named by the operators that make it
(``ops/attention.py``): the fused forward ``torchft_tpu_torch::attention_fwd``,
whose (o, lse) are saved together, so its backward never re-launches the
forward, and ``torchft_tpu_torch::attn_out``, the identity the
materialized path ends with. An ``attention_fn`` of plain ops (ring
attention) carries no name: "dots" and "attn" recompute it with the rest of
the layer, as its backward needs its intermediates anyway.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

# registers the attention operators under torch.ops.torchft_tpu_torch
from torchft_tpu_torch.ops import attention as _attention  # noqa: F401

__all__ = ["remat_wrap", "resolve_remat", "ATTN_OUT_NAME", "REMAT_MODES"]

ATTN_OUT_NAME = "attn_out"
REMAT_MODES = ("none", "dots", "attn", "full")

_aten = torch.ops.aten
# the operators whose outputs carry ATTN_OUT_NAME
_ATTN_OUT_OPS = [torch.ops.torchft_tpu_torch.attention_fwd.default,
                 torch.ops.torchft_tpu_torch.attn_out.default]
# what each selective mode saves; every other operator is recomputed
_SAVED = {
    "dots": [_aten.mm.default, _aten.addmm.default, *_ATTN_OUT_OPS],
    "attn": _ATTN_OUT_OPS,
}


def resolve_remat(remat: Any) -> str:
    """``remat`` as one of ``REMAT_MODES`` (bools as their aliases); raises
    ``ValueError`` for anything else."""
    if remat is False or remat == "none":
        return "none"
    if remat is True or remat == "full":
        return "full"
    if remat in ("dots", "attn"):
        return remat
    raise ValueError(f"unknown remat mode: {remat!r}")


def remat_wrap(layer: Callable, remat: Any) -> Callable:
    """``layer`` under the requested rematerialization mode: called with the
    layer's arguments, it returns the layer's outputs."""
    mode = resolve_remat(remat)
    if mode == "none":
        return layer
    if mode == "full":
        return functools.partial(checkpoint, layer, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts, _SAVED[mode])
    return functools.partial(checkpoint, layer, use_reentrant=False, context_fn=context_fn)
