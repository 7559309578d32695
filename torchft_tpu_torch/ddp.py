"""Fault-tolerant data parallelism helpers.

Counterpart of ``torchft_tpu/ddp.py:21-123``: a function and two wrappers
that average a gradient pytree (a dict of tensors, such as ``{name:
p.grad}``) across replica groups through the Manager, with its quorum
participation, zero contribution for non-participants and error
swallowing. The gradients are explicit, as in the reference, not gathered
by autograd hooks.
"""

from __future__ import annotations

from typing import Any, Optional

import torch.utils._pytree as pytree

from torchft_tpu_torch import bucketing
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.work import GradStream, Work

__all__ = ["DistributedDataParallel", "PureDistributedDataParallel", "ft_allreduce_gradients"]


def ft_allreduce_gradients(manager: Manager, grads: Any, should_quantize: bool = False) -> Any:
    """Average a gradient pytree across the participating replica groups,
    blocking: one streamed managed allreduce (buckets land while later ones
    are on the wire; ``should_quantize`` streams them fp8 with error
    feedback). On a communicator failure the gradients resolve to zeros and
    ``manager.should_commit()`` discards the step."""
    return manager.allreduce_streamed(grads, should_quantize=should_quantize).wait()


class DistributedDataParallel:
    """A Manager with gradient averaging for the replicated dimension: one
    managed allreduce for the whole gradient tree (the Manager buckets
    it)."""

    def __init__(self, manager: Manager, should_quantize: bool = False) -> None:
        self._manager = manager
        self._should_quantize = should_quantize

    def allreduce_gradients(self, grads: Any) -> Work:
        """Async: a Work whose future resolves to the averaged gradients."""
        return self._manager.allreduce(grads, should_quantize=self._should_quantize)

    def allreduce_gradients_streamed(self, grads: Any) -> GradStream:
        """Async with per-bucket completion: ``ready(i)`` turns true as
        bucket i lands."""
        return self._manager.allreduce_streamed(grads, should_quantize=self._should_quantize)

    def average_gradients(self, grads: Any) -> Any:
        """Blocking: the averaged gradient pytree."""
        return self.allreduce_gradients_streamed(grads).wait()


class PureDistributedDataParallel(DistributedDataParallel):
    """The per-bucket variant: leaves pack into same-dtype buckets of at
    most ``bucket_cap_bytes`` (this wrapper's cap, passed with each call)
    and each bucket is one collective. A single leaf, or a cap of 0, takes
    one managed allreduce per leaf."""

    def __init__(
        self,
        manager: Manager,
        should_quantize: bool = False,
        bucket_cap_bytes: Optional[int] = None,
    ) -> None:
        super().__init__(manager, should_quantize)
        self._bucket_cap_bytes = (
            int(bucket_cap_bytes) if bucket_cap_bytes is not None
            else bucketing.DEFAULT_BUCKET_CAP_BYTES
        )

    def average_gradients(self, grads: Any) -> Any:
        leaves, treedef = bucketing.tree_flatten(grads)
        if len(leaves) <= 1 or self._bucket_cap_bytes <= 0:
            works = [
                self._manager.allreduce(leaf, should_quantize=self._should_quantize)
                for leaf in leaves
            ]
            return pytree.tree_unflatten([w.get_future().wait() for w in works], treedef)
        return self._manager.allreduce_streamed(
            grads, bucket_cap_bytes=self._bucket_cap_bytes,
            should_quantize=self._should_quantize,
        ).wait()
