"""NAM (Non-overlapping Approximate Match) construction.

Faithful reimplementation of the reference's hit collection and
sweep-line merge:

* hit collection with the running min-length-diff rule
  (reference src/nam.cpp:68-85 add_to_hits_per_ref),
* `merge_hits_into_nams` — per-hit scan over open NAMs in insertion
  order (reference src/nam.cpp:370-536),
* `merge_hits_into_nams_fast` — per-open-NAM scan over groups of hits
  sharing a query start, used by the rescue path
  (reference src/nam.cpp:117-366),
* `find_nams` (reference src/nam.cpp:771-926) and `find_nams_rescue`
  (reference src/nam.cpp:955-1058, `pre_sort` configuration).

Per-reference-id groups are iterated in the reference's
robin_hood::unordered_map order (simulated natively from the first-touch
key sequence; see native.robinhood_order) because the NAM emission order
across contigs is downstream-observable in equal-score tie-breaks.

A copy of rabbitsalign_tpu/chain/nams.py: the host reference that the
device NAM front end (ops/chain_device.py, ops/front_device.py) is held
against. The mapping path builds its NAMs in the engine, not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..index.strobemer_index import StrobemerIndex
from ..seed.randstrobes import QueryRandstrobes
from ..utils.sorting import introsort

_INT_MAX = 2**31 - 1


def _rh_items(hits_per_ref: "HitsPerRef"):
    """hits_per_ref groups in the reference's robin_hood map iteration
    order (dict preserves first-touch order == the map's insertion order,
    from which the simulator reproduces the final slot order). Under
    RABBITSALIGN_TPU_NO_NATIVE the groups stay in insertion order."""
    items = list(hits_per_ref.items())
    if len(items) > 1:
        from .. import native

        perm = native.robinhood_order([ref_id for ref_id, _ in items])
        if perm is not None:
            items = [items[p] for p in perm]
    return items


@dataclass(slots=True)
class Nam:
    """reference src/nam.hpp:11-38"""

    nam_id: int = 0
    query_start: int = 0
    query_end: int = 0
    query_prev_hit_startpos: int = 0
    ref_start: int = 0
    ref_end: int = 0
    ref_prev_hit_startpos: int = 0
    n_hits: int = 0
    ref_id: int = 0
    score: float = 0.0
    is_rc: bool = False

    def ref_span(self) -> int:
        return self.ref_end - self.ref_start

    def query_span(self) -> int:
        return self.query_end - self.query_start

    def projected_ref_start(self) -> int:
        return max(0, self.ref_start - self.query_start)


# A hit is (query_start, query_end, ref_start, ref_end)
Hit = Tuple[int, int, int, int]
HitsPerRef = Dict[int, List[Hit]]


def _nam_score(n: Nam) -> float:
    """score = n_hits * (2*min_span - max_span), floored at 1
    (reference src/nam.cpp:313-315)."""
    mx = max(n.query_span(), n.ref_span())
    mn = min(n.query_span(), n.ref_span())
    v = 2 * mn - mx
    return float(n.n_hits * v) if v > 0 else 1.0


def _add_to_hits_per_ref(
    hits_per_ref: HitsPerRef,
    query_start: int,
    query_end: int,
    index: StrobemerIndex,
    position: int,
) -> None:
    """Walk the equal-hash run keeping only minimal-length-diff entries
    (reference src/nam.cpp:68-85)."""
    min_diff = _INT_MAX
    hashes = index.hashes
    n = hashes.shape[0]
    h0 = hashes[position]
    qspan = query_end - query_start
    k = index.k()
    while position < n and hashes[position] == h0:
        ref_start = int(index.positions[position])
        ref_end = ref_start + int(index.packed[position] & 0xFF) + k
        diff = abs(qspan - (ref_end - ref_start))
        if diff <= min_diff:
            ref_id = int(index.packed[position]) >> 8
            hits_per_ref.setdefault(ref_id, []).append(
                (query_start, query_end, ref_start, ref_end)
            )
            min_diff = diff
        position += 1


def _open_new_nam(hit: Hit, ref_id: int, is_rc: bool) -> Nam:
    qs, qe, rs, re = hit
    return Nam(
        query_start=qs,
        query_end=qe,
        ref_start=rs,
        ref_end=re,
        ref_id=ref_id,
        query_prev_hit_startpos=qs,
        ref_prev_hit_startpos=rs,
        n_hits=1,
        is_rc=is_rc,
    )


def _flush(open_nams: List[Nam], query_start: int, nams: List[Nam]) -> List[Nam]:
    """Emit and remove open NAMs fully left of query_start."""
    kept = []
    for n in open_nams:
        if n.query_end < query_start:
            n.score = _nam_score(n)
            n.nam_id = len(nams)
            nams.append(n)
        else:
            kept.append(n)
    return kept


def merge_hits_into_nams(
    hits_per_ref: HitsPerRef, k: int, sort: bool, is_revcomp: bool, nams: List[Nam]
) -> None:
    """reference src/nam.cpp:370-536"""
    for ref_id, hits in _rh_items(hits_per_ref):
        if sort:
            introsort(hits, [(h[0] << 32) | h[2] for h in hits], False)
        open_nams: List[Nam] = []
        prev_q_start = 0
        for hit in hits:
            qs, qe, rs, re = hit
            is_added = False
            for o in open_nams:
                if (
                    o.query_prev_hit_startpos < qs <= o.query_end
                    and o.ref_prev_hit_startpos < rs <= o.ref_end
                ):
                    if qe > o.query_end and re > o.ref_end:
                        o.query_end = qe
                        o.ref_end = re
                        o.query_prev_hit_startpos = qs
                        o.ref_prev_hit_startpos = rs
                        o.n_hits += 1
                        is_added = True
                        break
                    elif qe <= o.query_end and re <= o.ref_end:
                        o.query_prev_hit_startpos = qs
                        o.ref_prev_hit_startpos = rs
                        o.n_hits += 1
                        is_added = True
                        break
            if not is_added:
                open_nams.append(_open_new_nam(hit, ref_id, is_revcomp))
            # only filter when we advanced at least k nucleotides
            if qs > prev_q_start + k:
                open_nams = _flush(open_nams, qs, nams)
                prev_q_start = qs
        for n in open_nams:
            n.score = _nam_score(n)
            n.nam_id = len(nams)
            nams.append(n)


def merge_hits_into_nams_fast(
    hits_per_ref: HitsPerRef, k: int, sort: bool, is_revcomp: bool, nams: List[Nam]
) -> None:
    """Grouped variant used by the rescue path (reference src/nam.cpp:117-366):
    hits sharing a query start are processed as one group; each open NAM
    absorbs at most one hit from the group (binary-searched ref window)."""
    for ref_id, hits in _rh_items(hits_per_ref):
        if sort:
            introsort(hits, [(h[0] << 32) | h[2] for h in hits], False)
        open_nams: List[Nam] = []
        prev_q_start = 0
        i = 0
        n_hits_total = len(hits)
        while i < n_hits_total:
            i_start = i
            i_end = i + 1
            while i_end < n_hits_total and hits[i_end][0] == hits[i][0]:
                i_end += 1
            i = i_end
            group = list(hits[i_start:i_end])
            introsort(group, [(h[0] << 32) | h[2] for h in group], False)
            i_size = len(group)
            is_added = [False] * i_size
            query_start = group[0][0]
            cnt_done = 0
            ref_starts = [h[2] for h in group]

            for o in open_nams:
                lower = np.searchsorted(ref_starts, o.ref_prev_hit_startpos + 1, side="left")
                upper = np.searchsorted(ref_starts, o.ref_end + 1, side="left")
                for j in range(lower, upper):
                    if is_added[j]:
                        continue
                    if query_start <= o.query_end:
                        qs, qe, rs, re = group[j]
                        if o.ref_prev_hit_startpos < rs <= o.ref_end:
                            if qe > o.query_end and re > o.ref_end:
                                o.query_end = qe
                                o.ref_end = re
                                o.query_prev_hit_startpos = qs
                                o.ref_prev_hit_startpos = rs
                                o.n_hits += 1
                                is_added[j] = True
                                cnt_done += 1
                                break
                            elif qe <= o.query_end and re <= o.ref_end:
                                o.query_prev_hit_startpos = qs
                                o.ref_prev_hit_startpos = rs
                                o.n_hits += 1
                                is_added[j] = True
                                cnt_done += 1
                                break
                if cnt_done == i_size:
                    break

            for j in range(i_size):
                if not is_added[j]:
                    open_nams.append(_open_new_nam(group[j], ref_id, is_revcomp))

            if query_start > prev_q_start + k:
                open_nams = _flush(open_nams, query_start, nams)
                prev_q_start = query_start
        for n in open_nams:
            n.score = _nam_score(n)
            n.nam_id = len(nams)
            nams.append(n)


def find_nams(
    query_randstrobes: QueryRandstrobes, index: StrobemerIndex
) -> Tuple[float, List[Nam]]:
    """reference src/nam.cpp:771-926 (lookups vectorized over the read)."""
    hits_per_ref: List[HitsPerRef] = [{}, {}]
    nq = len(query_randstrobes)
    if nq == 0:
        return 1.0, []
    positions = index.find(query_randstrobes.hash)
    found = positions >= 0
    total_hits = int(np.sum(found))
    if total_hits:
        filtered = np.zeros(nq, dtype=bool)
        filtered[found] = index.is_filtered(positions[found])
    else:
        filtered = np.zeros(nq, dtype=bool)
    nr_good_hits = 0
    for i in np.flatnonzero(found):
        if filtered[i]:
            continue
        nr_good_hits += 1
        _add_to_hits_per_ref(
            hits_per_ref[bool(query_randstrobes.is_reverse[i])],
            int(query_randstrobes.start[i]),
            int(query_randstrobes.end[i]),
            index,
            int(positions[i]),
        )
    # reference computes the ratio in float32 (nam.cpp:753) and the <0.7
    # rescue gate later promotes it to double: keep the f32 rounding
    nonrepetitive_fraction = (
        float(np.float32(nr_good_hits) / np.float32(total_hits))
        if total_hits > 0 else 1.0
    )
    nams: List[Nam] = []
    for is_rc in (0, 1):
        merge_hits_into_nams(hits_per_ref[is_rc], index.k(), True, bool(is_rc), nams)
    return nonrepetitive_fraction, nams


def find_nams_rescue(
    query_randstrobes: QueryRandstrobes,
    index: StrobemerIndex,
    rescue_cutoff: int,
) -> List[Nam]:
    """reference src/nam.cpp:955-1058 (pre_sort configuration)."""
    hits_per_ref: List[HitsPerRef] = [{}, {}]
    nq = len(query_randstrobes)
    positions = index.find(query_randstrobes.hash) if nq else np.zeros(0, dtype=np.int64)
    found_idx = np.flatnonzero(positions >= 0)
    counts = (
        index.get_count(positions[found_idx]) if found_idx.size else np.zeros(0, dtype=np.int64)
    )
    counts = np.atleast_1d(counts)

    # RescueHit = (count, query_start, query_end, position)
    hits_fw: List[Tuple[int, int, int, int]] = []
    hits_rc: List[Tuple[int, int, int, int]] = []
    for j, i in enumerate(found_idx):
        rh = (
            int(counts[j]),
            int(query_randstrobes.start[i]),
            int(query_randstrobes.end[i]),
            int(positions[i]),
        )
        if query_randstrobes.is_reverse[i]:
            hits_rc.append(rh)
        else:
            hits_fw.append(rh)

    # 24-bit query-coordinate fields (16-bit would alias for >=64 kbp
    # reads); the count clamps to 16 bits to fit uint64 — order within
    # counts >= 65535 is unobservable, the take-rule walk hard-stops at
    # the first count > 1000 (reference nam.cpp:992), and (qs, qe) is
    # unique per strand so the observable region has no ties
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
            # pre-create the ref-id keys to fix the map iteration order
            # (reference add_to_hits_per_ref_pre, src/nam.cpp:87-107)
            _pre_create_keys(hits_per_ref[is_revcomp], rh[1], rh[2], index, rh[3])
            cnt += 1

    for i in range(2):
        introsort(rhs[i], [r[1] for r in rhs[i]], False)  # cmp2: query_start
        for rh in rhs[i]:
            _add_to_hits_per_ref(hits_per_ref[i], rh[1], rh[2], index, rh[3])

    nams: List[Nam] = []
    for is_rc in (0, 1):
        merge_hits_into_nams_fast(hits_per_ref[is_rc], index.k(), False, bool(is_rc), nams)
    return nams


def _pre_create_keys(
    hits_per_ref: HitsPerRef, query_start: int, query_end: int, index: StrobemerIndex, position: int
) -> None:
    """reference src/nam.cpp:87-107: walk the run applying the min-diff rule
    but only create (empty) per-ref entries."""
    min_diff = _INT_MAX
    hashes = index.hashes
    n = hashes.shape[0]
    h0 = hashes[position]
    qspan = query_end - query_start
    k = index.k()
    while position < n and hashes[position] == h0:
        ref_start = int(index.positions[position])
        ref_end = ref_start + int(index.packed[position] & 0xFF) + k
        diff = abs(qspan - (ref_end - ref_start))
        if diff <= min_diff:
            ref_id = int(index.packed[position]) >> 8
            hits_per_ref.setdefault(ref_id, [])
            min_diff = diff
        position += 1


def sort_nams_by_score(nams: List[Nam]) -> None:
    """Descending score with the reference's std::sort permutation."""
    introsort(nams, [n.score for n in nams], True)
