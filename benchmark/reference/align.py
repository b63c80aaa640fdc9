"""The plain reference of the aligner's scoring, in NumPy alone.

It imports nothing of the program. It states the alignment objective of
the reference aligner (strobealign's, which the program reproduces):
affine gaps (a gap of length L costs ``gap_open + (L - 1) * gap_extend``),
``+match`` / ``-mismatch`` a base pair, a local alignment on the target,
and ``end_bonus`` added for each end of the read that the alignment
reaches instead of soft-clipping it. Two functions:

- `best_scores`: the optimum of that objective of each read against a
  window of the genome, by dynamic programming over a batch of reads at
  once, in a given integer type (int32 for the reference; a narrower
  type for the control, whose arithmetic then wraps as the type does);
- `replay`: the score and edit distance that a SAM record's CIGAR gives
  when it is walked along the read and the genome.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Scoring:
    match: int = 2
    mismatch: int = 8
    gap_open: int = 12
    gap_extend: int = 1
    end_bonus: int = 10


def best_scores(reads: np.ndarray, windows: np.ndarray, sc: Scoring,
                dtype=np.int32) -> np.ndarray:
    """(B,) best objective score of read b against window b, computed in
    `dtype`. `reads` (B, n) and `windows` (B, m) hold base codes; a code
    above 3 in a window matches nothing.

    H[i, j] is the best score of an alignment of the read's first i bases
    ending at window base j: one that starts at the read's first base
    carries the end bonus from row 0, one that starts later starts from 0
    (the bases before it soft-clipped). A horizontal gap (a deletion from
    the read) is the running maximum of ``H[i, k] + k * E`` along the row,
    which is exact when gap_open >= gap_extend: reopening a gap is never
    better than extending it."""
    reads = np.asarray(reads)
    windows = np.asarray(windows)
    B, n = reads.shape
    m = windows.shape[1]
    t = np.asarray(dtype(0)).dtype.type
    a, b = t(sc.match), t(sc.mismatch)
    O, E, eb = t(sc.gap_open), t(sc.gap_extend), t(sc.end_bonus)
    zero = t(0)
    kE = (np.arange(m + 1) * int(sc.gap_extend)).astype(dtype)  # k * E, k = 0..m
    gap_at = (np.arange(m) * int(sc.gap_extend)).astype(dtype) + O  # O + (j - 1) * E
    with np.errstate(over="ignore"):
        H = np.full((B, m + 1), eb, dtype=dtype)  # row 0
        Ev = np.full((B, m), np.iinfo(dtype).min // 2, dtype=dtype)
        best = np.full(B, np.iinfo(dtype).min, dtype=dtype)
        for i in range(n):
            s = np.where(reads[:, i:i + 1] == windows, a, -b).astype(dtype)
            diag = H[:, :-1] + s
            Ev = np.maximum(H[:, 1:] - O, Ev - E)
            H0 = np.maximum(np.maximum(diag, Ev), zero)
            row = np.empty((B, m + 1), dtype=dtype)
            row[:, 0] = zero
            row[:, 1:] = H0
            G = np.maximum.accumulate(row + kE, axis=1)
            F = G[:, :-1] - gap_at
            row[:, 1:] = np.maximum(H0, F)
            H = row
            top = H[:, 1:].max(axis=1)
            if i == n - 1:
                top = top + eb
            best = np.maximum(best, top)
    return best


_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: bytes):
    """[(length, op)] of a CIGAR string, or None for '*' or a string
    that is not a CIGAR."""
    ops = [(int(n), op) for n, op in _CIGAR.findall(cigar)]
    if not ops or b"".join(b"%d%s" % (n, op) for n, op in ops) != cigar:
        return None
    return ops


def ref_span(ops) -> int:
    """Genome bases that the CIGAR covers."""
    return sum(n for n, op in ops if op in b"MD=XN")


def replay(ops, seq: np.ndarray, genome: np.ndarray, pos0: int, sc: Scoring):
    """(score, edits, read bases consumed) of the CIGAR `ops` (from
    `parse_cigar`) laid on `genome` from 0-based `pos0`, with the read
    `seq` as the record gives it (forward strand). Edits count
    mismatches, inserted and deleted bases, as NM does. None when the
    CIGAR leaves the genome or the read, or holds an op the aligner
    never writes."""
    i, j = 0, int(pos0)
    score = edits = 0
    first, last = 0, len(ops) - 1
    for k, (length, op) in enumerate(ops):
        if op == b"S":
            if k not in (first, last):
                return None
            i += length
        elif op in b"M=X":
            if i + length > len(seq) or j < 0 or j + length > len(genome):
                return None
            eq = int(np.count_nonzero(seq[i:i + length] == genome[j:j + length]))
            score += eq * sc.match - (length - eq) * sc.mismatch
            edits += length - eq
            i += length
            j += length
        elif op in b"ID":
            score -= sc.gap_open + (length - 1) * sc.gap_extend
            edits += length
            if op == b"I":
                i += length
            else:
                j += length
        else:
            return None
    if ops[0][1] != b"S":
        score += sc.end_bonus
    if ops[-1][1] != b"S":
        score += sc.end_bonus
    return score, edits, i
