"""Aligner facade: full gapped alignment with end-bonus soft-clip
extension.

`Aligner.align` reproduces the reference CPU path
(reference src/aligner.cpp:114-210): SSW local alignment, '='/'X'
cigar conversion with mismatch counting, then greedy extension to the
query ends claiming the end bonus when profitable.

`Aligner.align_from_ends` applies the identical post-processing to an
externally computed alignment (score/coordinates/cigar) — the integration
point for the batched device Smith-Waterman kernels, mirroring the
reference's GPU path (reference src/aligner.cpp:13-112 align_gpu).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.dna import encode
from .cigar import (
    CIGAR_DEL,
    CIGAR_EQ,
    CIGAR_INS,
    CIGAR_MATCH,
    CIGAR_SOFTCLIP,
    CIGAR_X,
    Cigar,
)
from .hamming import AlignmentInfo
from .ssw import SswResult, ssw_align


@dataclass(frozen=True)
class AlignmentParameters:
    """match is a score, the others are penalties (all nonnegative)
    (reference src/aligner.hpp:11-18)."""

    match: int = 2
    mismatch: int = 8
    gap_open: int = 12
    gap_extend: int = 1
    end_bonus: int = 10


def _eqx_and_mismatches(res: SswResult, q_codes: np.ndarray, r_codes: np.ndarray, query_len: int):
    """Convert the raw M/I/D cigar to S + =/X/I/D + S and count mismatches
    (X+I+D bases), comparing translated codes like the reference's
    CalculateNumberMismatch (ext/ssw/ssw_cpp.cpp:126-205)."""
    cigar = Cigar()
    if res.read_begin > 0:
        cigar.push(CIGAR_SOFTCLIP, res.read_begin)
    i = res.read_begin
    j = res.ref_begin
    mismatches = 0
    for op_len in res.cigar.ops:
        op = op_len & 0xF
        length = op_len >> 4
        if op == CIGAR_MATCH:
            a = q_codes[i : i + length]
            b = r_codes[j : j + length]
            eq = a == b
            mismatches += int(np.count_nonzero(~eq))
            if length:
                boundaries = np.flatnonzero(eq[1:] != eq[:-1]) + 1
                starts = np.concatenate([[0], boundaries])
                ends = np.concatenate([boundaries, [length]])
                for rs, re in zip(starts, ends):
                    cigar.push(CIGAR_EQ if eq[rs] else CIGAR_X, int(re - rs))
            i += length
            j += length
        elif op == CIGAR_INS:
            mismatches += length
            cigar.push(op, length)
            i += length
        elif op == CIGAR_DEL:
            mismatches += length
            cigar.push(op, length)
            j += length
    end_clip = query_len - res.read_end - 1
    if end_clip > 0:
        cigar.push(CIGAR_SOFTCLIP, end_clip)
    return cigar, mismatches


class Aligner:
    def __init__(self, parameters: AlignmentParameters):
        self.parameters = parameters
        self.m_align_calls = 0

    def calls_count(self) -> int:
        return self.m_align_calls

    def align(self, query: bytes, ref: bytes) -> AlignmentInfo:
        """reference src/aligner.cpp:114-210"""
        self.m_align_calls += 1
        p = self.parameters
        aln = AlignmentInfo()
        if len(ref) > 2000:
            aln.edit_distance = 100000
            aln.ref_start = 0
            aln.sw_score = -1000000
            return aln

        q_codes = encode(query)
        r_codes = encode(ref)
        res = ssw_align(q_codes, r_codes, p.match, p.mismatch, p.gap_open, p.gap_extend)
        if res.score1 == 0:
            # Nothing aligns anywhere (all-mismatch). The reference reads
            # out-of-bounds here (ref_begin1 == -1); treat as failed.
            aln.edit_distance = 100000
            aln.ref_start = 0
            aln.sw_score = -100000
            return aln
        if res.flag != 0:
            aln.edit_distance = 100000
            aln.ref_start = 0
            aln.sw_score = -100000
            return aln

        cigar, mismatches = _eqx_and_mismatches(res, q_codes, r_codes, len(query))
        aln.cigar = cigar
        aln.edit_distance = mismatches
        aln.sw_score = res.score1
        aln.ref_start = res.ref_begin
        aln.ref_end = res.ref_end + 1  # SSW ends are inclusive
        aln.query_start = res.read_begin
        aln.query_end = res.read_end + 1
        self._extend_to_ends(aln, query, ref)
        return aln

    def align_from_ends(
        self,
        query: bytes,
        ref: bytes,
        score: int,
        query_start: int,
        query_end: int,
        ref_start: int,
        ref_end: int,
        eqx_cigar: Cigar,
        edit_distance: int,
    ) -> AlignmentInfo:
        """End-bonus post-processing of an externally computed alignment
        (a batched device kernel result) — the analog of Aligner::align_gpu
        (reference src/aligner.cpp:13-112). `query_end`/`ref_end` are
        exclusive; `eqx_cigar` covers the aligned region only (soft clips
        are added here)."""
        self.m_align_calls += 1
        if len(ref) > 2000:
            aln = AlignmentInfo()
            aln.edit_distance = 100000
            aln.ref_start = 0
            aln.sw_score = -1000000
            return aln
        aln = AlignmentInfo()
        cigar = Cigar()
        if query_start > 0:
            cigar.push(CIGAR_SOFTCLIP, query_start)
        cigar += eqx_cigar
        end_clip = len(query) - query_end
        if end_clip > 0:
            cigar.push(CIGAR_SOFTCLIP, end_clip)
        aln.cigar = cigar
        aln.edit_distance = edit_distance
        aln.sw_score = score
        aln.ref_start = ref_start
        aln.ref_end = ref_end
        aln.query_start = query_start
        aln.query_end = query_end
        self._extend_to_ends(aln, query, ref)
        return aln

    def _extend_to_ends(self, aln: AlignmentInfo, query: bytes, ref: bytes) -> None:
        """Greedy extension to the query start/end claiming the end bonus
        when profitable (reference src/aligner.cpp:147-207). Character
        comparison, like the reference (N matches N here)."""
        p = self.parameters
        # front
        qstart = aln.query_start
        rstart = aln.ref_start
        score = aln.sw_score
        edits = aln.edit_distance
        front_ops = []
        while qstart > 0 and rstart > 0:
            qstart -= 1
            rstart -= 1
            if query[qstart] == ref[rstart]:
                score += p.match
                front_ops.append(CIGAR_EQ)
            else:
                score -= p.mismatch
                front_ops.append(CIGAR_X)
                edits += 1
        if qstart == 0 and score + p.end_bonus > aln.sw_score:
            front = Cigar()
            for op in reversed(front_ops):
                front.push(op, 1)
            if aln.query_start > 0:
                assert (aln.cigar.ops[0] & 0xF) == CIGAR_SOFTCLIP
                rest = Cigar(aln.cigar.ops[1:])
                front += rest
                aln.cigar = front
            elif front.ops:
                front += aln.cigar
                aln.cigar = front
            aln.query_start = 0
            aln.ref_start = rstart
            aln.sw_score = score + p.end_bonus
            aln.edit_distance = edits

        # back
        qend = aln.query_end
        rend = aln.ref_end
        score = aln.sw_score
        edits = aln.edit_distance
        back = Cigar()
        while qend < len(query) and rend < len(ref):
            if query[qend] == ref[rend]:
                score += p.match
                back.push(CIGAR_EQ, 1)
            else:
                score -= p.mismatch
                back.push(CIGAR_X, 1)
                edits += 1
            qend += 1
            rend += 1
        if qend == len(query) and score + p.end_bonus > aln.sw_score:
            if aln.query_end < len(query):
                assert (aln.cigar.ops[-1] & 0xF) == CIGAR_SOFTCLIP
                aln.cigar = Cigar(aln.cigar.ops[:-1])
            aln.cigar += back
            aln.query_end = len(query)
            aln.ref_end = rend
            aln.sw_score = score + p.end_bonus
            aln.edit_distance = edits
