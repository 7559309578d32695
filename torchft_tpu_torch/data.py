"""Data sharding across an elastic replica fleet.

Counterpart of ``torchft_tpu/data.py``, kept numpy-only so its indices are
the reference's exactly: shards a dataset across ``num_replica_groups x
group_world_size`` workers, the global shard index being ``group_rank +
group_world_size * replica_rank``. Lossy by design: on a membership change
replicas keep their static shard, trading some over- or under-sampling for
no resharding.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

__all__ = ["DistributedSampler", "StatefulDataIterator", "shard_indices"]


def shard_indices(
    num_samples: int,
    group_rank: int,
    replica_rank: int,
    group_world_size: int = 1,
    num_replica_groups: int = 1,
) -> tuple[int, int]:
    """Return this worker's (global_rank, total_shards)."""
    global_rank = group_rank + group_world_size * replica_rank
    total = group_world_size * num_replica_groups
    assert 0 <= global_rank < total, (global_rank, total)
    return global_rank, total


class DistributedSampler:
    """Epoch-shuffled index sampler over this worker's shard.

    Iterates indices ``i`` with ``i % total == global_rank`` after an
    epoch-seeded shuffle, like torch's DistributedSampler contract.
    """

    def __init__(
        self,
        num_samples: int,
        group_rank: int,
        replica_rank: int,
        group_world_size: int = 1,
        num_replica_groups: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        self._num_samples = num_samples
        self.global_rank, self.total_shards = shard_indices(
            num_samples, group_rank, replica_rank, group_world_size, num_replica_groups
        )
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        if self._drop_last:
            return self._num_samples // self.total_shards
        return (self._num_samples + self.total_shards - 1) // self.total_shards

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self._num_samples)
        if self._shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(order)
        n = len(self) * self.total_shards
        if not self._drop_last and n > self._num_samples:
            # pad by tiling, so every shard has equal length even when the
            # dataset is smaller than the shard count
            order = np.resize(order, n)
        else:
            order = order[:n]
        yield from order[self.global_rank :: self.total_shards].tolist()


class StatefulDataIterator:
    """Resumable iteration over a DistributedSampler.

    ``state_dict()`` / ``load_state_dict()`` capture (epoch, offset) and
    belong in the state registered with the Manager, so a healed replica
    resumes from its recovery source's batch position. Epochs advance when
    a shard is exhausted.
    """

    def __init__(self, sampler: DistributedSampler) -> None:
        self._sampler = sampler
        self._epoch = 0
        self._offset = 0
        self._cache_epoch: Optional[int] = None
        self._cache: list = []

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset}

    def load_state_dict(self, sd: dict) -> None:
        self._epoch = int(sd["epoch"])
        self._offset = int(sd["offset"])

    def _shard(self) -> list:
        if self._cache_epoch != self._epoch:
            self._sampler.set_epoch(self._epoch)
            self._cache = list(self._sampler)
            self._cache_epoch = self._epoch
        return self._cache

    def __iter__(self) -> "StatefulDataIterator":
        return self

    def __next__(self) -> int:
        shard = self._shard()
        if self._offset >= len(shard):
            self._epoch += 1
            self._offset = 0
            shard = self._shard()
            if not shard:
                raise ValueError(
                    "sampler shard is empty (num_samples < total shards with "
                    "drop_last=True); nothing to iterate"
                )
        idx = shard[self._offset]
        self._offset += 1
        return int(idx)
