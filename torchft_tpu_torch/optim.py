"""Fault-tolerant optimizer wrapper.

Counterpart of ``torchft_tpu/optim.py:22`` over ``torch.optim``:
``zero_grad`` starts the step's quorum and ``step`` applies the update only
when the commit vote succeeds, otherwise the step is discarded. A live
heal lands inside the vote (the registered load fns write the recovered
model and optimizer state in place), so the update that follows applies to
the healed state, keeping a just-healed replica in lockstep with the
cohort whose average gradient it received.
"""

from __future__ import annotations

import torch

from torchft_tpu_torch.manager import Manager

__all__ = ["OptimizerWrapper"]


class OptimizerWrapper:
    """Usage::

        optimizer = OptimizerWrapper(manager, torch.optim.AdamW(model.parameters()))
        for batch in data:
            optimizer.zero_grad()            # starts the quorum
            loss = model.loss(*batch); loss.backward()
            grads = {n: p.grad for n, p in model.named_parameters()}
            avg = manager.allreduce(grads).get_future().wait()
            for n, p in model.named_parameters(): p.grad = avg[n]
            optimizer.step()                 # vote, then update if committed
    """

    def __init__(self, manager: Manager, optim: torch.optim.Optimizer) -> None:
        self.manager = manager
        self.optim = optim

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.manager.start_quorum()
        self.optim.zero_grad(set_to_none=set_to_none)

    def step(self) -> bool:
        """Vote; apply the update iff the step committed. Returns the vote."""
        if not self.manager.should_commit():
            return False
        self.optim.step()
        return True
