"""Randstrobe generation from canonical syncmers.

Semantics follow the reference exactly:

* linking: for strobe1 = syncmer i, the partner strobe2 is the syncmer
  j in the window [i+w_min, min(i+w_max, n-1)] with position <=
  position[i] + max_dist minimizing popcount((hash_i ^ hash_j) & q);
  ties keep the first (leftmost) candidate; if the window is empty the
  strobe is paired with itself
  (reference src/randstrobes.cpp:148-171 RandstrobeIterator::get and
  :173-202 RandstrobeGenerator::next — both yield identical output).
* randstrobe hash = hash1 + hash2 (wrapping uint64)
  (reference src/randstrobes.cpp:48-50).
* number of randstrobes = max(0, n_syncmers - w_min)
  (reference src/index.cpp:28-41 count_randstrobes and
  src/randstrobes.hpp:111-113 has_next).
* sequences shorter than w_max produce nothing
  (reference src/index.cpp:280-282, src/randstrobes.cpp:209-211).
* query side: forward randstrobes from forward syncmers; then syncmer
  list reversed with positions mirrored (pos -> len - pos - k) and
  randstrobes generated again for the reverse-complement strand
  (reference src/randstrobes.cpp:207-253 randstrobes_query).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .hash import popcount64
from .syncmers import syncmers
from ..index.params import IndexParameters

_U64 = np.uint64


@dataclasses.dataclass
class QueryRandstrobes:
    """Struct-of-arrays of QueryRandstrobe records
    (reference src/randstrobes.hpp:51-56)."""

    hash: np.ndarray  # uint64
    start: np.ndarray  # int32 (strobe1 start)
    end: np.ndarray  # int32 (strobe2 start + k)
    is_reverse: np.ndarray  # bool

    def __len__(self) -> int:
        return self.hash.shape[0]


def link_randstrobes(
    positions: np.ndarray,
    hashes: np.ndarray,
    w_min: int,
    w_max: int,
    q: int,
    max_dist: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pair up syncmers into randstrobes (vectorized).

    Returns (hash uint64, strobe1_pos, strobe2_pos) arrays of length
    max(0, n - w_min).
    """
    n = positions.shape[0]
    n_out = n - w_min
    if n_out <= 0:
        return (
            np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
        )
    width = w_max - w_min + 1
    i_idx = np.arange(n_out)
    # candidate indices (n_out, width)
    j_idx = i_idx[:, None] + w_min + np.arange(width)[None, :]
    valid = j_idx < n
    j_clip = np.minimum(j_idx, n - 1)
    cand_pos = positions[j_clip]
    valid &= cand_pos <= (positions[i_idx][:, None] + max_dist)
    xor = hashes[i_idx][:, None] ^ hashes[j_clip]
    metric = popcount64(xor & _U64(q)).astype(np.int64)
    metric = np.where(valid, metric, np.int64(1 << 40))
    best = np.argmin(metric, axis=1)  # first minimum wins (leftmost)
    any_valid = valid.any(axis=1)
    strobe2_idx = np.where(any_valid, i_idx + w_min + best, i_idx)
    with np.errstate(over="ignore"):
        rs_hash = hashes[i_idx] + hashes[strobe2_idx]
    return rs_hash, positions[i_idx], positions[strobe2_idx]


def randstrobes_reference(
    seq: bytes | str, params: IndexParameters
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All randstrobes of one reference contig:
    (hash uint64, strobe1_pos int64, strobe2_pos int64)."""
    rp = params.randstrobe
    sp = params.syncmer
    if len(seq) < rp.w_max:
        return (
            np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
        )
    pos, h = syncmers(seq, sp.k, sp.s, sp.t_syncmer)
    return link_randstrobes(pos, h, rp.w_min, rp.w_max, rp.q, rp.max_dist)


def randstrobes_query(seq: bytes | str, params: IndexParameters) -> QueryRandstrobes:
    """Query randstrobes for both strands (reference src/randstrobes.cpp:207-253)."""
    rp = params.randstrobe
    sp = params.syncmer
    k = sp.k
    empty = QueryRandstrobes(
        np.zeros(0, dtype=np.uint64),
        np.zeros(0, dtype=np.int32),
        np.zeros(0, dtype=np.int32),
        np.zeros(0, dtype=bool),
    )
    if len(seq) < rp.w_max:
        return empty
    pos, h = syncmers(seq, k, sp.s, sp.t_syncmer)
    if pos.shape[0] == 0:
        return empty

    fh, f1, f2 = link_randstrobes(pos, h, rp.w_min, rp.w_max, rp.q, rp.max_dist)

    # reverse-complement strand: reverse syncmer list, mirror positions
    rpos = (len(seq) - pos - k)[::-1].copy()
    rh = h[::-1].copy()
    bh, b1, b2 = link_randstrobes(rpos, rh, rp.w_min, rp.w_max, rp.q, rp.max_dist)

    return QueryRandstrobes(
        hash=np.concatenate([fh, bh]),
        start=np.concatenate([f1, b1]).astype(np.int32),
        end=(np.concatenate([f2, b2]) + k).astype(np.int32),
        is_reverse=np.concatenate(
            [np.zeros(fh.shape[0], dtype=bool), np.ones(bh.shape[0], dtype=bool)]
        ),
    )
