"""Integer hashes used across the pipeline.

Semantics match the reference implementations exactly (cited per function);
all arithmetic is modular uint64/uint32 as in C.

The port's copy of `mm2tpu/utils/hashing.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key: int, mask: int = 0xFFFFFFFFFFFFFFFF) -> int:
    """Thomas Wang's invertible 64-bit mix, masked to 2k bits.

    Reference: sketch.c:28-38 (masked, used on k-mers) and hit.c:40-50
    (unmasked, used for chain tie-breaking).
    """
    M = 0xFFFFFFFFFFFFFFFF
    key = ((~key & M) + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_array(key: np.ndarray, mask: int = 0xFFFFFFFFFFFFFFFF) -> np.ndarray:
    """Vectorized hash64 over a uint64 array (sketch.c:28-38)."""
    key = key.astype(_U64, copy=True)
    m = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & m
        key ^= key >> _U64(24)
        key = (key + (key << _U64(3)) + (key << _U64(8))) & m
        key ^= key >> _U64(14)
        key = (key + (key << _U64(2)) + (key << _U64(4))) & m
        key ^= key >> _U64(28)
        key = (key + (key << _U64(31))) & m
    return key


def wang_hash32(key: int) -> int:
    """32-bit Wang hash (khash.h __ac_Wang_hash), uint32 modular."""
    M = 0xFFFFFFFF
    key = (key + (~(key << 15) & M)) & M
    key ^= key >> 10
    key = (key + (key << 3)) & M
    key ^= key >> 6
    key = (key + (~(key << 11) & M)) & M
    key ^= key >> 16
    return key


def x31_hash_string(s: str | bytes) -> int:
    """X31 string hash (khash.h __ac_X31_hash_string), uint32 modular."""
    if isinstance(s, str):
        s = s.encode()
    h = 0
    for c in s:
        h = ((h << 5) - h + c) & 0xFFFFFFFF
    return h


def reg_hash(qname: str | None, qlen_sum: int, seed: int) -> int:
    """Per-read tie-breaking hash (map.c:290-292)."""
    h = x31_hash_string(qname) if qname is not None else 0
    h ^= (wang_hash32(qlen_sum) + wang_hash32(seed)) & 0xFFFFFFFF
    h &= 0xFFFFFFFF
    return wang_hash32(h)


_LOG_TABLE256 = np.full(256, -1, dtype=np.int32)
for _i in range(1, 256):
    _LOG_TABLE256[_i] = int(np.floor(np.log2(_i)))


def ilog2_32(v: int) -> int:
    """Integer log2 (chain.c:22-27); ilog2_32(0) == -1 like the LUT."""
    return int(v).bit_length() - 1


def ilog2_32_array(v: np.ndarray) -> np.ndarray:
    """Vectorized integer log2 for uint32-ish arrays; 0 maps to -1."""
    v = v.astype(np.uint32)
    r = np.zeros(v.shape, dtype=np.int32)
    t = v.copy()
    for shift in (16, 8, 4, 2, 1):
        big = t >= (1 << shift)
        r[big] += shift
        t[big] >>= shift
    r[v == 0] = -1
    return r
