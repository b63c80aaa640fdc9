"""Gapless alignment fast path.

Ports of the reference's hamming_distance (src/aligner.hpp:54-67),
highest_scoring_segment (src/aligner.cpp:219-252) and hamming_align
(src/aligner.cpp:254-302). The segment scan is numpy-vectorized using the
clamped-random-walk identity s_i = R_i - min(0, cummin(R)_i); reset
positions are recovered from strict decreases of the clamped cummin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .cigar import CIGAR_EQ, CIGAR_SOFTCLIP, CIGAR_X, Cigar


@dataclass
class AlignmentInfo:
    """reference src/aligner.hpp:20-30"""

    cigar: Cigar = field(default_factory=Cigar)
    edit_distance: int = 0
    ref_start: int = 0
    ref_end: int = 0
    query_start: int = 0
    query_end: int = 0
    sw_score: int = 0

    def ref_span(self) -> int:
        return self.ref_end - self.ref_start


def hamming_distance(s: bytes, t: bytes) -> int:
    if len(s) != len(t):
        return -1
    a = np.frombuffer(s, dtype=np.uint8)
    b = np.frombuffer(t, dtype=np.uint8)
    return int(np.count_nonzero(a != b))


def highest_scoring_segment(
    query: bytes, ref: bytes, match: int, mismatch: int, end_bonus: int
) -> Tuple[int, int, int]:
    """Best gapless segment under +match/-mismatch scoring with end_bonus
    granted for touching either end of the query. Returns
    (segment_start, segment_end, score)."""
    n = len(query)
    if n == 0:
        # loop body never runs: score stays end_bonus, final check applies
        if 2 * end_bonus > 0:
            return 0, 0, 2 * end_bonus
        return 0, 0, 0
    a = np.frombuffer(query, dtype=np.uint8)
    b = np.frombuffer(ref, dtype=np.uint8)[:n]
    v = np.where(a == b, match, -mismatch).astype(np.int64)
    R = end_bonus + np.cumsum(v)
    C = np.minimum(np.minimum.accumulate(R), 0)
    s = R - C
    # reset after position j whenever the clamped cummin strictly decreased
    Cprev = np.empty(n, dtype=np.int64)
    Cprev[0] = 0
    Cprev[1:] = C[:-1]
    dec = C < Cprev
    start_at = np.maximum.accumulate(np.where(dec, np.arange(1, n + 1), 0))

    best_i = int(np.argmax(s))
    best_score = int(s[best_i])
    if best_score <= 0:
        best_start, best_end, best_score = 0, 0, 0
    else:
        best_start, best_end = int(start_at[best_i]), best_i + 1

    final_score = int(s[-1])
    if final_score + end_bonus > best_score:
        best_score = final_score + end_bonus
        best_end = n
        best_start = int(start_at[-1])
    return best_start, best_end, best_score


def hamming_align(
    query: bytes, ref: bytes, match: int, mismatch: int, end_bonus: int
) -> AlignmentInfo:
    """reference src/aligner.cpp:254-302"""
    aln = AlignmentInfo()
    if len(query) != len(ref):
        return aln
    segment_start, segment_end, score = highest_scoring_segment(
        query, ref, match, mismatch, end_bonus
    )

    cigar = Cigar()
    if segment_start > 0:
        cigar.push(CIGAR_SOFTCLIP, segment_start)

    mismatches = 0
    if segment_end > segment_start:
        a = np.frombuffer(query, dtype=np.uint8)[segment_start:segment_end]
        b = np.frombuffer(ref, dtype=np.uint8)[segment_start:segment_end]
        is_match = a == b
        mismatches = int(np.count_nonzero(~is_match))
        # run-length encode the match/mismatch mask
        boundaries = np.flatnonzero(is_match[1:] != is_match[:-1]) + 1
        run_starts = np.concatenate([[0], boundaries])
        run_ends = np.concatenate([boundaries, [is_match.shape[0]]])
        for rs, re in zip(run_starts, run_ends):
            cigar.push(CIGAR_EQ if is_match[rs] else CIGAR_X, int(re - rs))

    soft_right = len(query) - segment_end
    if soft_right > 0:
        cigar.push(CIGAR_SOFTCLIP, soft_right)

    aln.cigar = cigar
    aln.sw_score = score
    aln.edit_distance = mismatches
    aln.ref_start = segment_start
    aln.ref_end = segment_end
    aln.query_start = segment_start
    aln.query_end = segment_end
    return aln
