"""The port's data sharding against the JAX package's, exactly.

``torchft_tpu_torch/data.py`` is numpy-only, as the reference is: the shard
of each worker, the sampler's indices in every epoch (shuffled or not,
with and without ``drop_last``), and ``StatefulDataIterator``'s resume
mid-epoch and epoch rollover must be the reference's, index for index,
over a grid of dataset sizes, ranks and epochs.
"""

import itertools

import pytest

from torchft_tpu import data as ref
from torchft_tpu_torch import data as port

SIZES = (1, 3, 10, 17, 64)
LAYOUTS = ((1, 1), (1, 2), (2, 3), (4, 1))  # (group_world_size, num_replica_groups)


@pytest.mark.parametrize("num_samples", SIZES)
@pytest.mark.parametrize("group_world_size,num_replica_groups", LAYOUTS)
def test_shard_indices_equal_the_reference(num_samples, group_world_size, num_replica_groups):
    for group_rank, replica_rank in itertools.product(
        range(group_world_size), range(num_replica_groups)
    ):
        args = (num_samples, group_rank, replica_rank, group_world_size, num_replica_groups)
        assert port.shard_indices(*args) == ref.shard_indices(*args)


def test_shard_indices_reject_an_out_of_range_rank():
    with pytest.raises(AssertionError):
        port.shard_indices(10, 0, 2, 1, 2)
    with pytest.raises(AssertionError):
        ref.shard_indices(10, 0, 2, 1, 2)


@pytest.mark.parametrize("num_samples", SIZES)
@pytest.mark.parametrize("group_world_size,num_replica_groups", LAYOUTS)
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True), (False, False),
                                               (False, True)])
def test_sampler_indices_equal_the_reference(num_samples, group_world_size,
                                             num_replica_groups, shuffle, drop_last):
    for group_rank, replica_rank in itertools.product(
        range(group_world_size), range(num_replica_groups)
    ):
        kw = dict(num_samples=num_samples, group_rank=group_rank, replica_rank=replica_rank,
                  group_world_size=group_world_size, num_replica_groups=num_replica_groups,
                  shuffle=shuffle, seed=11, drop_last=drop_last)
        p, r = port.DistributedSampler(**kw), ref.DistributedSampler(**kw)
        assert (p.global_rank, p.total_shards) == (r.global_rank, r.total_shards)
        assert len(p) == len(r)
        for epoch in range(3):
            p.set_epoch(epoch)
            r.set_epoch(epoch)
            got = list(p)
            assert got == list(r)
            assert all(type(i) is int for i in got)


def _iterators(num_samples, replica_rank, num_replica_groups, seed, drop_last=False):
    kw = dict(num_samples=num_samples, group_rank=0, replica_rank=replica_rank,
              num_replica_groups=num_replica_groups, seed=seed, drop_last=drop_last)
    return (port.StatefulDataIterator(port.DistributedSampler(**kw)),
            ref.StatefulDataIterator(ref.DistributedSampler(**kw)))


@pytest.mark.parametrize("num_samples,num_replica_groups", [(10, 2), (17, 3), (8, 2), (5, 4)])
@pytest.mark.parametrize("cut", [0, 1, 3, 7, 12])
def test_iterator_resumes_mid_epoch_and_rolls_over_as_the_reference(
        num_samples, num_replica_groups, cut):
    """Both iterators over three epochs (rollover included), then both
    resumed from a state dict taken after ``cut`` indices: the port's
    indices and states are the reference's at every point."""
    for replica_rank in range(num_replica_groups):
        p, r = _iterators(num_samples, replica_rank, num_replica_groups, seed=3)
        n = 3 * len(p._sampler)
        head_p = [next(p) for _ in range(cut)]
        head_r = [next(r) for _ in range(cut)]
        assert head_p == head_r
        sd = p.state_dict()
        assert sd == r.state_dict()
        tail_p = [next(p) for _ in range(n)]
        assert tail_p == [next(r) for _ in range(n)]
        assert p.state_dict() == r.state_dict()

        resumed_p, resumed_r = _iterators(num_samples, replica_rank, num_replica_groups, seed=3)
        resumed_p.load_state_dict(sd)
        resumed_r.load_state_dict(sd)
        assert [next(resumed_p) for _ in range(n)] == tail_p
        assert [next(resumed_r) for _ in range(n)] == tail_p


def test_iterator_epoch_rollover_reshuffles():
    p, _ = _iterators(8, 0, 2, seed=1)
    epoch0 = [next(p) for _ in range(4)]
    epoch1 = [next(p) for _ in range(4)]
    assert p.state_dict()["epoch"] == 1
    assert epoch0 != epoch1


def test_iterator_over_an_empty_shard_raises_as_the_reference():
    p, r = _iterators(1, 1, 2, seed=0, drop_last=True)
    with pytest.raises(ValueError, match="empty"):
        next(p)
    with pytest.raises(ValueError, match="empty"):
        next(r)
