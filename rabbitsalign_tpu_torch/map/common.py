"""Shared mapping-core pieces: parameters, insert-size estimator, NAM
orientation fixing, seed extension (reference src/aln.{hpp,cpp})."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..align.aligner import Aligner
from ..align.hamming import AlignmentInfo, hamming_align, hamming_distance
from ..chain.nams import Nam
from ..io.fasta import References
from ..io.sam import Alignment
from ..utils.dna import Read
from .randomness import MinstdRand, shuffle

F32 = np.float32

# float32 transcendentals through glibc's libm: the reference binds
# logf/expf (math.h float overloads) and numpy's own float32 log/exp
# differ from glibc by 1 ulp on ~4% of inputs — enough to flip a tie or
# an int-truncated mapq (probed; sqrt needs no shim, IEEE requires
# correct rounding so every implementation agrees)
import ctypes as _ct
import ctypes.util as _ctu

_libm = _ct.CDLL(_ctu.find_library("m") or "libm.so.6")
_libm.logf.restype = _ct.c_float
_libm.logf.argtypes = [_ct.c_float]
_libm.expf.restype = _ct.c_float
_libm.expf.argtypes = [_ct.c_float]


def logf(x) -> np.float32:
    """glibc logf, bit-exact with the reference's float log."""
    return F32(_libm.logf(float(x)))


def expf(x) -> np.float32:
    """glibc expf, bit-exact with the reference's float exp."""
    return F32(_libm.expf(float(x)))


def f32_window(mu: float, sigma: float, k: int):
    """``mu + k * sigma`` with the reference's float32 arithmetic. The
    reference computes every insert-size window in `float` (aln.cpp
    rescue/pairing/proper-pair sites), so a coordinate or distance
    compared against it is ALSO rounded to float32 — observable at
    reference positions past 2^24 bp and under estimator drift."""
    return F32(F32(mu) + F32(k) * F32(sigma))


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
    # windows fixed at decision time — the reference's align_PE_read and
    # this repo's default); True = replicate the reference BINARY's async
    # production path exactly (per-chunk estimator reset + rescue windows
    # recomputed at gather time, reference src/pc.cpp:1100-1519)
    pe_ref_async: bool = False

    def verify(self) -> None:
        if self.max_tries < 1:
            raise ValueError("max_tries must be greater than zero")
        if not (0.0 <= self.dropoff_threshold <= 1.0):
            # a threshold above 1 makes even the best NAM fail its own
            # dropoff (ratio exactly 1.0) so no alignment is ever tried —
            # the reference hits undefined behavior there; fail instead
            raise ValueError("dropoff threshold (-S) must be within [0, 1]")


class InsertSizeDistribution:
    """Online mean/stddev estimator (reference src/aln.hpp:79-89, update at
    src/aln.cpp:1880-1903). State and arithmetic are FLOAT32 like the
    reference's `float` members: a double-accumulated twin drifts ~1e-4
    after a few hundred updates, enough to flip the int-truncated rescue
    and proper-pair windows built from mu + k*sigma. The two spots where
    the reference mixes in a double literal (V's and sample_size's
    ``1.0``) promote and round back exactly as C++ does."""

    def __init__(self):
        self.sample_size = F32(1.0)
        self.mu = F32(300.0)
        self.sigma = F32(100.0)
        self.V = F32(10000.0)
        self.SSE = F32(10000.0)

    def update(self, dist: int) -> None:
        if dist >= 2000:
            return
        e = F32(F32(dist) - self.mu)
        self.mu = F32(self.mu + F32(e / self.sample_size))
        self.SSE = F32(self.SSE + F32(e * F32(F32(dist) - self.mu)))
        if self.sample_size > 1:
            self.V = F32(float(self.SSE) / (float(self.sample_size) - 1.0))
        else:
            self.V = self.SSE
        self.sigma = F32(np.sqrt(self.V))
        self.sample_size = F32(float(self.sample_size) + 1.0)


def reverse_nam_if_needed(nam: Nam, read: Read, references: References, k: int) -> bool:
    """Check/fix NAM orientation via its first and last strobe k-mers
    (reference src/aln.cpp:60-93). Mutates `nam` when flipped."""
    ref = references.sequences[nam.ref_id]
    ref_start_kmer = ref[nam.ref_start : nam.ref_start + k]
    ref_end_kmer = ref[nam.ref_end - k : nam.ref_end]

    if nam.is_rc:
        seq, seq_rc = read.rc, read.seq
    else:
        seq, seq_rc = read.seq, read.rc
    read_start_kmer = seq[nam.query_start : nam.query_start + k]
    read_end_kmer = seq[nam.query_end - k : nam.query_end]
    if ref_start_kmer == read_start_kmer and ref_end_kmer == read_end_kmer:
        return True

    read_len = read.size()
    q_start_tmp = read_len - nam.query_end
    q_end_tmp = read_len - nam.query_start
    read_start_kmer = seq_rc[q_start_tmp : q_start_tmp + k]
    read_end_kmer = seq_rc[q_end_tmp - k : q_end_tmp]
    if ref_start_kmer == read_start_kmer and ref_end_kmer == read_end_kmer:
        nam.is_rc = not nam.is_rc
        nam.query_start = q_start_tmp
        nam.query_end = q_end_tmp
        return True
    return False


def extend_seed(
    aligner: Aligner,
    nam: Nam,
    references: References,
    read: Read,
    consistent_nam: bool,
) -> Alignment:
    """Extend a NAM to cover the whole read (reference src/aln.cpp:437-491):
    Hamming fast path when the projection is consistent and same-length with
    <5% mismatches, else gapped alignment on the +-50bp window."""
    query = read.rc if nam.is_rc else read.seq
    ref = references.sequences[nam.ref_id]

    projected_ref_start = max(0, nam.ref_start - nam.query_start)
    projected_ref_end = min(nam.ref_end + len(query) - nam.query_end, len(ref))

    info: Optional[AlignmentInfo] = None
    result_ref_start = 0
    gapped = True
    if projected_ref_end - projected_ref_start == len(query) and consistent_nam:
        ref_segm_ham = ref[projected_ref_start : projected_ref_start + len(query)]
        hd = hamming_distance(query, ref_segm_ham)
        if hd >= 0 and hd / len(query) < 0.05:
            info = hamming_align(
                query, ref_segm_ham, aligner.parameters.match,
                aligner.parameters.mismatch, aligner.parameters.end_bonus,
            )
            result_ref_start = projected_ref_start + info.ref_start
            gapped = False
    if gapped:
        diff = abs(nam.ref_span() - nam.query_span())
        ext_left = min(50, projected_ref_start)
        ref_start = projected_ref_start - ext_left
        ext_right = min(50, len(ref) - nam.ref_end)
        ref_segm_size = read.size() + diff + ext_left + ext_right
        ref_segm = ref[ref_start : ref_start + ref_segm_size]
        info = aligner.align(query, ref_segm)
        result_ref_start = ref_start + info.ref_start

    softclipped = info.query_start + (len(query) - info.query_end)
    return Alignment(
        cigar=info.cigar,
        edit_distance=info.edit_distance,
        global_ed=info.edit_distance + softclipped,
        score=info.sw_score,
        ref_start=result_ref_start,
        length=info.ref_span(),
        is_rc=nam.is_rc,
        is_unaligned=False,
        ref_id=nam.ref_id,
        gapped=gapped,
    )


def get_mapq(nams: List[Nam], n_max: Nam) -> int:
    """NAM-based mapq, minimap2-style (reference src/aln.cpp:493-503).
    The reference's s1/s2/min_matches are float32 and the WHOLE product
    chain is float32, including log(s1): aln.cpp includes <math.h>,
    whose C++ global float overload makes its unqualified log(float) a
    float log (probe-verified)."""
    if len(nams) <= 1:
        return 60
    s1 = F32(n_max.score)
    s2 = F32(nams[1].score)
    min_matches = F32(min(n_max.n_hits / 10.0, 1.0))
    x = F32(F32(F32(40) * F32(F32(1) - F32(s2 / s1))) * min_matches)
    uncapped_mapq = int(F32(x * logf(s1)))
    return min(uncapped_mapq, 60)


def top_dropoff(nams: List[Nam]) -> float:
    """reference src/aln.cpp:1361-1370"""
    n_max = nams[0]
    if n_max.n_hits <= 2:
        return 1.0
    if len(nams) > 1:
        return nams[1].n_hits / n_max.n_hits
    return 0.0


def shuffle_top_nams(nams: List[Nam], random_engine: MinstdRand) -> None:
    """Shuffle the maximal-score prefix (reference src/aln.cpp:1910-1925)."""
    if not nams:
        return
    best_score = nams[0].score
    it = len(nams)
    for i, nam in enumerate(nams):
        if nam.score != best_score:
            it = i
            break
    if it != len(nams):
        head = nams[:it]
        shuffle(head, random_engine)
        nams[:it] = head


def normal_pdf(x: float, mu: float, sigma: float) -> float:
    """float32-precision normal pdf (reference src/aln.cpp:529-534);
    exp routes through glibc expf for bit-exactness."""
    inv_sqrt_2pi = F32(0.3989422804014327)
    a = (F32(x) - F32(mu)) / F32(sigma)
    return float(inv_sqrt_2pi / F32(sigma) * expf(F32(-0.5) * a * a))
