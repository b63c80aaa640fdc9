"""Index parameters: syncmer (k, s, t) and randstrobe (l, u, q, max_dist, w_min, w_max).

Semantics reproduce the reference parameter derivation
(reference src/indexparameters.cpp:26-83 and
reference src/indexparameters.hpp:11-95), including the
read-length profile table and the `.rNNN.sti` filename extension rule.
"""

from __future__ import annotations

import dataclasses
import struct


class BadParameter(ValueError):
    pass


DEFAULT = -(2**31)  # sentinel matching IndexParameters::DEFAULT (INT_MIN)

# profile table: (canonical_read_length, r_threshold, k, s_offset, l, u)
# reference src/indexparameters.cpp:37-45
_PROFILES = [
    (50, 90, 20, -4, -3, 2),
    (100, 110, 20, -4, -2, 2),
    (125, 135, 20, -4, -1, 4),
    (150, 175, 20, -4, 1, 7),
    (250, 275, 20, -4, 4, 13),
    (300, 375, 22, -4, 2, 12),
    (400, 2**31 - 1, 23, -6, 2, 12),
]


@dataclasses.dataclass(frozen=True)
class SyncmerParameters:
    k: int
    s: int

    @property
    def t_syncmer(self) -> int:
        return (self.k - self.s) // 2 + 1

    def __post_init__(self):
        if self.k <= 7 or self.k > 32:
            raise BadParameter("k not in [8,32]")
        if self.s > self.k:
            raise BadParameter("s is larger than k")
        if (self.k - self.s) % 2 != 0:
            raise BadParameter(
                "(k - s) must be an even number to create canonical syncmers. "
                "Please set s to e.g. k-2, k-4, k-6, ..."
            )


@dataclasses.dataclass(frozen=True)
class RandstrobeParameters:
    l: int
    u: int
    q: int  # uint64 mask
    max_dist: int
    w_min: int
    w_max: int

    def __post_init__(self):
        if self.max_dist > 255:
            raise BadParameter("maximum seed length (-m <max_dist>) is larger than 255")
        if self.w_min > self.w_max:
            raise BadParameter("w_min is greater than w_max (choose different -l/-u parameters)")


@dataclasses.dataclass(frozen=True)
class IndexParameters:
    canonical_read_length: int
    syncmer: SyncmerParameters
    randstrobe: RandstrobeParameters

    @staticmethod
    def create(canonical_read_length: int, k: int, s: int, l: int, u: int, q: int, max_dist: int) -> "IndexParameters":
        # w_min/w_max derivation: reference src/indexparameters.hpp:80-84
        w_min = max(0, k // (k - s + 1) + l)
        w_max = k // (k - s + 1) + u
        return IndexParameters(
            canonical_read_length=canonical_read_length,
            syncmer=SyncmerParameters(k, s),
            randstrobe=RandstrobeParameters(l, u, q, max_dist, w_min, w_max),
        )

    @staticmethod
    def from_read_length(
        read_length: int,
        k: int = DEFAULT,
        s: int = DEFAULT,
        l: int = DEFAULT,
        u: int = DEFAULT,
        c: int = DEFAULT,
        max_seed_len: int = DEFAULT,
    ) -> "IndexParameters":
        """reference src/indexparameters.cpp:51-83"""
        default_c = 8
        canonical_read_length = 50
        for crl, r_threshold, pk, s_offset, pl, pu in _PROFILES:
            if read_length <= r_threshold:
                if k == DEFAULT:
                    k = pk
                if s == DEFAULT:
                    s = k + s_offset
                if l == DEFAULT:
                    l = pl
                if u == DEFAULT:
                    u = pu
                canonical_read_length = crl
                break

        if max_seed_len == DEFAULT:
            max_dist = max(canonical_read_length - 70, k)
            max_dist = min(255, max_dist)
        else:
            max_dist = max_seed_len - k  # convert to distance in start positions
        q = 2 ** (default_c if c == DEFAULT else c) - 1

        return IndexParameters.create(canonical_read_length, k, s, l, u, q, max_dist)

    def filename_extension(self) -> str:
        """'.rNNN.sti' when nothing was overridden, else '.sti'
        (reference src/indexparameters.cpp:117-125)."""
        if self == IndexParameters.from_read_length(self.canonical_read_length):
            return f".r{self.canonical_read_length}.sti"
        return ".sti"

    # --- binary (de)serialization, 7 little-endian int32 values
    # (reference src/indexparameters.cpp:85-104)
    def write(self, f) -> None:
        f.write(
            struct.pack(
                "<7i",
                self.canonical_read_length,
                self.syncmer.k,
                self.syncmer.s,
                self.randstrobe.l,
                self.randstrobe.u,
                self.randstrobe.q,
                self.randstrobe.max_dist,
            )
        )

    @staticmethod
    def read(f) -> "IndexParameters":
        crl, k, s, l, u, q, max_dist = struct.unpack("<7i", f.read(28))
        return IndexParameters.create(crl, k, s, l, u, q, max_dist)
