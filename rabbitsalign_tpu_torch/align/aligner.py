"""Alignment scoring parameters (reference src/aligner.hpp:11-18). The
aligner itself is the C++ engine's (host SSW + end-bonus
post-processing of device results)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlignmentParameters:
    """match is a score, the others are penalties (all nonnegative)
    (reference src/aligner.hpp:11-18)."""

    match: int = 2
    mismatch: int = 8
    gap_open: int = 12
    gap_extend: int = 1
    end_bonus: int = 10
