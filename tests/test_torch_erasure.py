"""The port's erasure codec (``torchft_tpu_torch/checkpointing/erasure.py``)
against the reference's (``torchft_tpu/checkpointing/erasure.py``) on the
cases of ``tests/test_erasure.py``: every shard and every decode of the
same seeded payload is the reference's, byte for byte, zero-length and odd
lengths included, over every geometry and every k-subset of shards."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torchft_tpu.checkpointing import erasure as ref
from torchft_tpu_torch.checkpointing import erasure as port


def _payloads():
    rng = np.random.RandomState(7)
    f = rng.randn(97).astype(np.float32)
    f[3] = np.nan
    f[11] = np.inf
    f[12] = -np.inf
    f[17] = np.float32(1e-42)  # subnormal
    f[23] = -0.0
    yield "float-specials", f.tobytes()
    yield "odd-7b", b"\x01\x02\x03\x04\x05\x06\x07"
    yield "one-byte", b"\xff"
    yield "empty", b""
    yield "prime-size", rng.bytes(1009)
    yield "aligned", rng.bytes(4096)


GEOMETRIES = [(1, 1), (2, 1), (3, 2), (4, 2), (8, 3)]


def _encode_both(payload, k, m):
    ours = port.encode_shards(payload, k, m)
    theirs = ref.encode_shards(payload, k, m)
    assert [bytes(s) for s in ours] == theirs
    return ours, theirs


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_roundtrip_bitwise_all_payloads_as_the_reference(k, m):
    for name, payload in _payloads():
        shards, ref_shards = _encode_both(payload, k, m)
        assert len(shards) == k + m, name
        slen = port.shard_length(len(payload), k)
        assert slen == ref.shard_length(len(payload), k)
        assert all(len(s) == slen for s in shards), name
        # systematic: the data shards are the payload's slices
        assert b"".join(shards[:k])[:len(payload)] == payload, name
        out = port.decode_shards(list(shards), k, m, len(payload))
        assert bytes(out) == ref.decode_shards(ref_shards, k, m, len(payload)) == payload, name


@pytest.mark.parametrize("n", [0, 1, 2, 3, 255, 256, 257, 4093, 65537])
@pytest.mark.parametrize("k,m", [(2, 1), (3, 2), (8, 2)])
def test_seeded_payload_shards_are_the_reference_bytes(n, k, m):
    """Random payloads from a seed, zero-length and odd lengths, the shard
    crcs too."""
    payload = np.random.RandomState(1000 * k + 10 * m + n % 7).bytes(n)
    shards, ref_shards = _encode_both(payload, k, m)
    assert [port.shard_crc(s) for s in shards] == [ref.shard_crc(s) for s in ref_shards]


@pytest.mark.parametrize("k,m", [(2, 1), (3, 2), (4, 2)])
def test_every_k_subset_decodes_as_the_reference(k, m):
    payload = np.random.RandomState(k * 10 + m).bytes(257)
    shards, ref_shards = _encode_both(payload, k, m)
    for keep in itertools.combinations(range(k + m), k):
        slots = [shards[i] if i in keep else None for i in range(k + m)]
        ref_slots = [ref_shards[i] if i in keep else None for i in range(k + m)]
        got = bytes(port.decode_shards(slots, k, m, len(payload)))
        assert got == ref.decode_shards(ref_slots, k, m, len(payload)) == payload, keep
        # the rows a holder of the present data shards repairs in place
        slen = port.shard_length(len(payload), k)
        for d, row in port.missing_data_rows(slots, k, m, len(payload)).items():
            assert slots[d] is None
            assert row.tobytes() == (payload + bytes(k * slen))[d * slen:(d + 1) * slen]


def test_below_k_survivors_is_unrecoverable_in_both():
    payload = b"abcdefgh" * 9
    k, m = 3, 2
    shards, ref_shards = _encode_both(payload, k, m)
    for mod, sh in ((port, shards), (ref, ref_shards)):
        slots = [sh[0], None, None, sh[3], None]
        with pytest.raises(ValueError, match="unrecoverable"):
            mod.decode_shards(slots, k, m, len(payload))
    with pytest.raises(ValueError, match="unrecoverable"):
        port.missing_data_rows([shards[0], None, None, shards[3], None], k, m, len(payload))


@settings(max_examples=25, deadline=None)
@given(k=st.integers(1, 6), m=st.integers(1, 4))
def test_any_k_rows_invertible_property(k, m):
    """Every k-subset of generator rows is invertible, and the generator is
    the reference's."""
    gen = port.encoding_matrix(k, m)
    np.testing.assert_array_equal(gen, ref.encoding_matrix(k, m))
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))
    for rows in itertools.combinations(range(k + m), k):
        inv = port._gf_matinv(gen[list(rows)])  # raises ValueError if singular
        np.testing.assert_array_equal(inv, ref._gf_matinv(gen[list(rows)]))


def test_xor_fast_path_m1_parity_is_xor():
    k = 4
    payload = np.random.RandomState(3).bytes(k * 32)
    shards, _ = _encode_both(payload, k, 1)
    xor = np.zeros(32, dtype=np.uint8)
    for i in range(k):
        xor ^= np.frombuffer(shards[i], dtype=np.uint8)
    assert xor.tobytes() == bytes(shards[k])
    np.testing.assert_array_equal(port.encoding_matrix(k, 1)[k], np.ones(k, np.uint8))


def test_data_shards_are_views_of_the_payload():
    """The memory difference from the reference: full data rows are views
    (no copy of a 6.45 GB payload); only the padded last row is new."""
    payload = np.random.RandomState(4).bytes(1001)
    shards = port.encode_shards(payload, 2, 1)
    base = np.frombuffer(payload, dtype=np.uint8)
    assert np.shares_memory(np.frombuffer(shards[0], dtype=np.uint8), base)
    assert not np.shares_memory(np.frombuffer(shards[1], dtype=np.uint8), base)
    assert all(s.readonly for s in shards)


def test_corrupt_shard_detected_by_crc_and_repaired():
    k, m = 4, 2
    payload = np.random.RandomState(11).bytes(1000)
    shards, ref_shards = _encode_both(payload, k, m)
    crcs = [port.shard_crc(s) for s in shards]
    assert crcs == [ref.shard_crc(s) for s in ref_shards]
    bad = bytearray(shards[2])
    bad[5] ^= 0x40
    assert port.shard_crc(bytes(bad)) != crcs[2]
    slots = [None if i == 2 else shards[i] for i in range(k + m)]
    assert bytes(port.decode_shards(slots, k, m, len(payload))) == payload


@pytest.mark.parametrize("call", [
    lambda mod: mod.encoding_matrix(0, 1),
    lambda mod: mod.encoding_matrix(200, 100),
    lambda mod: mod.decode_shards([b"x", b"y"], 2, 1, 2),  # wrong slot count
])
def test_geometry_validation_as_the_reference(call):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            call(mod)
