"""Mapping parameters (reference src/aln.hpp:58-75). Mapping decisions
themselves run in the C++ engine."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MappingParameters:
    """reference src/aln.hpp:58-75"""

    r: int = 150
    max_secondary: int = 0
    dropoff_threshold: float = 0.5
    rescue_level: int = 2
    max_tries: int = 20
    rescue_cutoff: int = 0
    is_sam_out: bool = True
    cigar_eqx: bool = False
    output_unmapped: bool = True
    details: bool = False
    # PE insert-size semantics: False = monolithic (cumulative estimator,
    # windows fixed at decision time); True = replicate the reference
    # binary's async production path exactly (per-chunk estimator reset +
    # rescue windows recomputed at gather time,
    # reference src/pc.cpp:1100-1519)
    pe_ref_async: bool = False

    def verify(self) -> None:
        if self.max_tries < 1:
            raise ValueError("max_tries must be greater than zero")
        if not (0.0 <= self.dropoff_threshold <= 1.0):
            # a threshold above 1 makes even the best NAM fail its own
            # dropoff (ratio exactly 1.0) so no alignment is ever tried —
            # the reference hits undefined behavior there; fail instead
            raise ValueError("dropoff threshold (-S) must be within [0, 1]")
