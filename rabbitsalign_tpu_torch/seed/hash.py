"""Single-u64 xxh64 bit mixer, vectorized over numpy arrays.

Semantics match the reduced xxh64 used for seed hashing in the reference
(reference src/hash.hpp:105-118): the finalize/avalanche part of
xxHash64 specialized to a single 8-byte input.
"""

from __future__ import annotations

import numpy as np

PRIME64_1 = np.uint64(0x9E3779B185EBCA87)
PRIME64_2 = np.uint64(0xC2B2AE3D27D4EB4F)
PRIME64_3 = np.uint64(0x165667B19E3779F9)
PRIME64_4 = np.uint64(0x85EBCA77C2B2AE63)
PRIME64_5 = np.uint64(0x27D4EB2F165667C5)

_U64 = np.uint64


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def xxh64(x) -> np.ndarray:
    """xxh64 of a single uint64 (scalar or array), wrapping mod 2^64."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint64)
        result = PRIME64_5 + _U64(8)
        inp = x * PRIME64_2
        inp = _rotl64(inp, 31)
        result = result ^ (inp * PRIME64_1)
        result = _rotl64(result, 27)
        result = result * PRIME64_1 + PRIME64_4
        result ^= result >> _U64(33)
        result = result * PRIME64_2
        result ^= result >> _U64(29)
        result = result * PRIME64_3
        result ^= result >> _U64(32)
        return result


def popcount64(x) -> np.ndarray:
    """Population count of uint64 values (vectorized)."""
    x = np.asarray(x, dtype=np.uint64)
    x = x - ((x >> _U64(1)) & _U64(0x5555555555555555))
    x = (x & _U64(0x3333333333333333)) + ((x >> _U64(2)) & _U64(0x3333333333333333))
    x = (x + (x >> _U64(4))) & _U64(0x0F0F0F0F0F0F0F0F)
    with np.errstate(over="ignore"):
        return (x * _U64(0x0101010101010101)) >> _U64(56)
