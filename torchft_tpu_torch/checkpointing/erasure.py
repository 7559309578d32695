"""Systematic erasure codec of the redundancy plane (numpy, on the host).

Counterpart of ``torchft_tpu/checkpointing/erasure.py``: ``k`` data shards
+ ``m`` parity shards over GF(256), any ``k`` of the ``k + m`` reconstruct
the payload bitwise. The code is systematic (the first ``k`` shards are
the payload's slices), so a reconstruct whose data holders are all alive
is a concatenation, and parity arithmetic runs only for missing or corrupt
shards. The generator is the reference's Vandermonde-then-normalize matrix
(``m == 1``: the all-ones XOR row), built from the same field tables, so
for the same payload bytes every shard is the reference's, byte for byte.

One difference, in memory only: the reference returns ``bytes`` copies.
Here ``encode_shards`` returns read-only memoryviews, data shards as views
of the payload wherever the payload fills them (only the zero-padded last
row is a copy), parity as views of the arrays the parity was summed in;
``decode_shards`` returns a view of the one array it decodes into. At
bench_1b's 6.45 GB a copy of the payload is 6.45 GB of host memory, and
three replicas staging at once share one host. The caller keeps the
payload alive and unchanged while it uses the shards.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "encode_shards",
    "decode_shards",
    "encoding_matrix",
    "missing_data_rows",
    "shard_crc",
    "shard_length",
]

_GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _GF_POLY
    exp[255:510] = exp[0:255]  # wraparound: exp[a + b] needs no mod
    # MUL[a, b] = a * b in GF(256): 64 KiB, built once
    a = np.arange(256, dtype=np.int32)
    la, lb = np.meshgrid(log[a], log[a], indexing="ij")
    mul = exp[(la + lb) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul


_EXP: Optional[np.ndarray] = None
_LOG: Optional[np.ndarray] = None
_MUL: Optional[np.ndarray] = None


def _tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    global _EXP, _LOG, _MUL
    if _MUL is None:
        _EXP, _LOG, _MUL = _build_tables()
    return _EXP, _LOG, _MUL  # type: ignore[return-value]


def _gf_mul_scalar(a: int, b: int) -> int:
    return int(_tables()[2][a, b])


def _gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    exp, log, _ = _tables()
    return int(exp[255 - int(log[a])])


def _gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(256) for small coefficient matrices."""
    mul = _tables()[2]
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        acc = np.zeros(b.shape[1], dtype=np.uint8)
        for t in range(a.shape[1]):
            acc ^= mul[a[i, t]][b[t]]
        out[i] = acc
    return out


def _gf_matinv(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(256); raises ValueError if singular."""
    mul = _tables()[2]
    n = mat.shape[0]
    aug = np.concatenate([mat.astype(np.uint8).copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = mul[_gf_inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= mul[int(aug[r, col])][aug[col]]
    return aug[:, n:]


def encoding_matrix(k: int, m: int) -> np.ndarray:
    """The systematic ``(k+m) x k`` generator: the identity on top, the
    parity coefficient rows below. Deterministic in (k, m)."""
    if k < 1 or m < 0 or k + m > 255:
        raise ValueError(f"unsupported erasure geometry k={k} m={m}")
    _tables()
    if m == 1:
        # the identity and one all-ones row: any k rows are invertible and
        # neither encode nor repair multiplies in the field
        return np.concatenate([np.eye(k, dtype=np.uint8), np.ones((1, k), dtype=np.uint8)])
    # Vandermonde over the points 0..k+m-1 (0^0 == 1), normalized so its top
    # k x k block is the identity: any k of its rows stay invertible
    vand = np.zeros((k + m, k), dtype=np.uint8)
    for r in range(k + m):
        acc = 1
        for c in range(k):
            vand[r, c] = acc
            acc = _gf_mul_scalar(acc, r)
    gen = _gf_matmul(vand, _gf_matinv(vand[:k]))
    gen[:k] = np.eye(k, dtype=np.uint8)
    return gen


def shard_length(data_len: int, k: int) -> int:
    """Bytes per shard for a payload of ``data_len`` (ceil-div, at least 1,
    so a zero-length payload still has addressable shards)."""
    return max(1, (int(data_len) + k - 1) // k)


def _combine(coefs: np.ndarray, rows: Sequence[np.ndarray], slen: int) -> np.ndarray:
    """sum_t coefs[t] * rows[t] over GF(256): XOR where a coefficient is 1."""
    mul = _tables()[2]
    acc = np.zeros(slen, dtype=np.uint8)
    for c, row in zip(coefs, rows):
        c = int(c)
        if c == 0:
            continue
        acc ^= row if c == 1 else mul[c][row]
    return acc


def encode_shards(payload, k: int, m: int) -> List[memoryview]:
    """``payload`` (bytes-like) as ``k + m`` shards of ``shard_length`` bytes.

    Shards ``0..k-1`` are the payload's slices (the last zero-padded),
    ``k..k+m-1`` the GF(256) parity: the reference's bytes, as read-only
    memoryviews (module docstring)."""
    data = np.frombuffer(memoryview(payload).cast("B"), dtype=np.uint8)
    slen = shard_length(data.nbytes, k)
    rows: List[np.ndarray] = []
    for i in range(k):
        row = data[i * slen:(i + 1) * slen]
        if row.nbytes < slen:
            padded = np.zeros(slen, dtype=np.uint8)
            padded[:row.nbytes] = row
            row = padded
        rows.append(row)
    gen = encoding_matrix(k, m)
    parity = [_combine(gen[k + p], rows, slen) for p in range(m)]
    return [memoryview(r).toreadonly() for r in rows + parity]


def _present(shards: Sequence[Optional[object]], k: int, m: int) -> List[int]:
    if len(shards) != k + m:
        raise ValueError(f"expected {k + m} shard slots, got {len(shards)}")
    present = [i for i, s in enumerate(shards) if s is not None]
    if len(present) < k:
        raise ValueError(
            f"unrecoverable: only {len(present)} of {k + m} shards present (need {k})"
        )
    return present


def _rows(shards: Sequence[Optional[object]], idx: Sequence[int]) -> List[np.ndarray]:
    return [np.frombuffer(memoryview(shards[i]).cast("B"), dtype=np.uint8) for i in idx]


def missing_data_rows(
    shards: Sequence[Optional[object]], k: int, m: int, data_len: int
) -> Dict[int, np.ndarray]:
    """The data shards missing from ``shards`` (the ``k + m`` slot list,
    ``None`` where missing), each rebuilt from the first ``k`` present
    shards: ``{index: row}``, empty when every data shard is present. What
    a caller holding the present data shards in place needs to complete
    the payload without a second copy of it. Raises ``ValueError`` when
    fewer than ``k`` shards are present."""
    use = _present(shards, k, m)[:k]
    missing = [d for d in range(k) if shards[d] is None]
    if not missing:
        return {}
    slen = shard_length(data_len, k)
    rows = _rows(shards, use)
    for r in rows:
        if r.nbytes != slen:
            raise ValueError(f"shard length mismatch: got {r.nbytes}, expected {slen}")
    dec = _gf_matinv(encoding_matrix(k, m)[use])
    return {d: _combine(dec[d], rows, slen) for d in missing}


def decode_shards(
    shards: Sequence[Optional[object]], k: int, m: int, data_len: int
) -> memoryview:
    """The payload from any ``k`` present shards.

    ``shards`` is the full ``k + m`` slot list, ``None`` for a missing or
    corrupt shard (a shard that failed its crc32 is dropped before). Raises
    ``ValueError`` when fewer than ``k`` are present. Returns the payload's
    ``data_len`` bytes as a read-only memoryview."""
    repaired = missing_data_rows(shards, k, m, data_len)
    # systematic: the present data shards are the payload's own rows
    rows = [repaired[d] if d in repaired else _rows(shards, [d])[0] for d in range(k)]
    out = np.concatenate(rows)
    return memoryview(out[:data_len]).toreadonly()


def shard_crc(shard) -> int:
    """crc32 of a shard body: the checksum family of the HTTP transport's
    trailers, so a corrupt shard is caught before it reaches the decoder."""
    return zlib.crc32(memoryview(shard).cast("B")) & 0xFFFFFFFF
