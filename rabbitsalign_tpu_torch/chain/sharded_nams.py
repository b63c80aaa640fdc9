"""NAM construction from sharded-index lookups.

`find_nams_sharded` / `find_nams_rescue_sharded` are the
whole-genome-scale twins of chain/nams.py's `find_nams` /
`find_nams_rescue`: the per-randstrobe index lookups (first position,
count, repetitive filter, equal-hash run records) are served by
`parallel.sharding.ShardedIndex.find_runs` — one batched lookup on
every shard's device (the `find_runs` kernel, csrc/find_runs.cu, on a
card) — and the hit walk then consumes the
prefetched (position, packed) run rows instead of touching host index
arrays. Everything downstream (min-length-diff rule, robin_hood group
order, introsort permutations, sweep-line merges) reuses the validated
host implementations, so the NAM output is identical element for
element. A copy of rabbitsalign_tpu/chain/sharded_nams.py.

Reference semantics covered: StrobemerIndex::find/get_count/is_filtered
(reference src/index.hpp:57-147), add_to_hits_per_ref
(reference src/nam.cpp:68-85), find_nams
(reference src/nam.cpp:771-926) and find_nams_rescue
(reference src/nam.cpp:955-1058).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..seed.randstrobes import QueryRandstrobes
from ..utils.sorting import introsort
from .nams import (
    _INT_MAX,
    HitsPerRef,
    Nam,
    merge_hits_into_nams,
    merge_hits_into_nams_fast,
)

RESCUE_RUN_CAP = 1000  # find_nams_rescue's hard stop: runs with
# count > 1000 are never walked (reference src/nam.cpp:992)


def _add_hits_from_run(
    hits_per_ref: HitsPerRef,
    query_start: int,
    query_end: int,
    k: int,
    run_positions: np.ndarray,
    run_packed: np.ndarray,
    count: int,
) -> None:
    """add_to_hits_per_ref (reference src/nam.cpp:68-85) over a
    prefetched run row: keep only running-minimal length-diff entries."""
    min_diff = _INT_MAX
    qspan = query_end - query_start
    for j in range(count):
        ref_start = int(run_positions[j])
        packed = int(run_packed[j])
        ref_end = ref_start + (packed & 0xFF) + k
        diff = abs(qspan - (ref_end - ref_start))
        if diff <= min_diff:
            hits_per_ref.setdefault(packed >> 8, []).append(
                (query_start, query_end, ref_start, ref_end)
            )
            min_diff = diff


def _pre_create_keys_from_run(
    hits_per_ref: HitsPerRef,
    query_start: int,
    query_end: int,
    k: int,
    run_positions: np.ndarray,
    run_packed: np.ndarray,
    count: int,
) -> None:
    """add_to_hits_per_ref_pre (reference src/nam.cpp:87-107): apply the
    min-diff rule but only first-touch the per-ref keys (fixes the
    robin_hood map iteration order for the rescue path)."""
    min_diff = _INT_MAX
    qspan = query_end - query_start
    for j in range(count):
        ref_start = int(run_positions[j])
        packed = int(run_packed[j])
        ref_end = ref_start + (packed & 0xFF) + k
        diff = abs(qspan - (ref_end - ref_start))
        if diff <= min_diff:
            hits_per_ref.setdefault(packed >> 8, [])
            min_diff = diff


def find_nams_sharded(
    query_randstrobes: QueryRandstrobes, sharded_index
) -> Tuple[float, List[Nam]]:
    """find_nams (reference src/nam.cpp:771-926) with lookups served by
    the sharded index. Unfiltered runs have count <= filter_cutoff,
    so cap=filter_cutoff fetches every record the walk can touch."""
    hits_per_ref: List[HitsPerRef] = [{}, {}]
    nq = len(query_randstrobes)
    if nq == 0:
        return 1.0, []
    cap = max(1, sharded_index.filter_cutoff)
    res = sharded_index.find_runs(query_randstrobes.hash, cap)
    found = res["position"] >= 0
    total_hits = int(np.sum(found))
    filtered = res["filtered"]
    k = sharded_index.k()
    nr_good_hits = 0
    for i in np.flatnonzero(found):
        if filtered[i]:
            continue
        nr_good_hits += 1
        _add_hits_from_run(
            hits_per_ref[bool(query_randstrobes.is_reverse[i])],
            int(query_randstrobes.start[i]),
            int(query_randstrobes.end[i]),
            k,
            res["run_positions"][i],
            res["run_packed"][i],
            int(res["count"][i]),
        )
    nonrepetitive_fraction = (
        float(np.float32(nr_good_hits) / np.float32(total_hits))
        if total_hits > 0 else 1.0
    )
    nams: List[Nam] = []
    for is_rc in (0, 1):
        merge_hits_into_nams(hits_per_ref[is_rc], k, True, bool(is_rc), nams)
    return nonrepetitive_fraction, nams


def find_nams_rescue_sharded(
    query_randstrobes: QueryRandstrobes,
    sharded_index,
    rescue_cutoff: int,
) -> List[Nam]:
    """find_nams_rescue (reference src/nam.cpp:955-1058) with lookups
    served by the sharded index: repetitive runs are walked too, so
    the fetch cap is the rescue path's own hard stop (1000)."""
    hits_per_ref: List[HitsPerRef] = [{}, {}]
    nq = len(query_randstrobes)
    if nq == 0:
        nams: List[Nam] = []
        return nams
    res = sharded_index.find_runs(query_randstrobes.hash, RESCUE_RUN_CAP)
    found_idx = np.flatnonzero(res["position"] >= 0)
    k = sharded_index.k()

    # RescueHit = (count, query_start, query_end, query-index)
    hits_fw: List[Tuple[int, int, int, int]] = []
    hits_rc: List[Tuple[int, int, int, int]] = []
    for i in found_idx:
        rh = (
            int(res["count"][i]),
            int(query_randstrobes.start[i]),
            int(query_randstrobes.end[i]),
            int(i),
        )
        if query_randstrobes.is_reverse[i]:
            hits_rc.append(rh)
        else:
            hits_fw.append(rh)

    # 24-bit fields for the query coordinates so the packed key orders
    # exactly like the reference's (count, qs, qe) tuple compare for any
    # read length (16-bit fields would alias for reads >= 64 kbp). The
    # count clamps to 16 bits to keep the key inside uint64: relative
    # order WITHIN counts >= 65535 is unobservable — the take-rule walk
    # hard-stops at the first count > 1000 (reference nam.cpp:992)
    key = lambda r: (min(r[0], 0xFFFF) << 48) | (r[1] << 24) | r[2]
    introsort(hits_fw, [key(r) for r in hits_fw], False)
    introsort(hits_rc, [key(r) for r in hits_rc], False)

    rhs: List[List[Tuple[int, int, int, int]]] = [[], []]
    for is_revcomp, rescue_hits in enumerate((hits_fw, hits_rc)):
        cnt = 0
        for rh in rescue_hits:
            count = rh[0]
            if (count > rescue_cutoff and cnt >= 5) or count > 1000:
                break
            rhs[is_revcomp].append(rh)
            qi = rh[3]
            _pre_create_keys_from_run(
                hits_per_ref[is_revcomp], rh[1], rh[2], k,
                res["run_positions"][qi], res["run_packed"][qi], count,
            )
            cnt += 1

    for i in range(2):
        introsort(rhs[i], [r[1] for r in rhs[i]], False)  # cmp2: query_start
        for rh in rhs[i]:
            qi = rh[3]
            _add_hits_from_run(
                hits_per_ref[i], rh[1], rh[2], k,
                res["run_positions"][qi], res["run_packed"][qi], rh[0],
            )

    nams: List[Nam] = []
    for is_rc in (0, 1):
        merge_hits_into_nams_fast(hits_per_ref[is_rc], k, False, bool(is_rc), nams)
    return nams
