"""Paired-end mapping core (reference src/aln.cpp:1582-1823 align_PE plus
pairing/rescue helpers).

Ports: joint NAM pairing with per-orientation sort + binary-searched
insert window (get_best_scoring_nam_pairs, "fast_loop3" configuration),
mate rescue by windowed alignment gated on a shared substring, one-sided
rescue, scored-pair deduplication, random top-pair pick, joint mapq, and
the online insert-size estimator (in common.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..align.aligner import Aligner
from ..chain.nams import Nam
from ..index.params import IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.paf import output_hits_paf_PE
from ..io.sam import Alignment, Details, Sam, SamRecord, is_proper_pair
from ..align.cigar import Cigar
from ..utils.dna import Read
from ..utils.sorting import introsort
from .common import (
    F32,
    logf,
    InsertSizeDistribution,
    MappingParameters,
    extend_seed,
    f32_window,
    get_mapq,
    normal_pdf,
    reverse_nam_if_needed,
    top_dropoff,
)
from .randomness import MinstdRand, uniform_int
from .se import get_nams_for_read


@dataclass
class NamPair:
    score: int
    nam1: Nam
    nam2: Nam


@dataclass
class ScoredAlignmentPair:
    score: float
    alignment1: Alignment
    alignment2: Alignment


def is_proper_nam_pair(nam1: Nam, nam2: Nam, mu: float, sigma: float) -> bool:
    """reference src/aln.cpp:560-577"""
    if nam1.ref_id != nam2.ref_id or nam1.is_rc == nam2.is_rc:
        return False
    a = max(0, nam1.ref_start - nam1.query_start)
    b = max(0, nam2.ref_start - nam2.query_start)
    w = f32_window(mu, sigma, 10)  # float32 window: distances round too
    r1_r2 = nam2.is_rc and (a <= b) and (F32(b - a) < w)
    if r1_r2:
        return True
    r2_r1 = nam1.is_rc and (b <= a) and (F32(a - b) < w)
    return r2_r1


def get_best_scoring_nam_pairs(
    nams1: List[Nam], nams2: List[Nam], mu: float, sigma: float
) -> List[NamPair]:
    """reference src/aln.cpp:591-996 (the active "fast_loop3" variant):
    proper pairs via per-orientation projected-start sort + binary-searched
    insert window, then unpaired high-scoring singles with dummy partners."""
    joint_nam_scores: List[NamPair] = []
    if not nams1 and not nams2:
        return joint_nam_scores

    added_n1 = set()
    added_n2 = set()
    best_joint_hits = 0

    nams2_sorted: List[List[Nam]] = [[], []]
    for nam2 in nams2:
        nams2_sorted[int(nam2.is_rc)].append(nam2)
    for lst in nams2_sorted:
        introsort(lst, [max(0, n.ref_start - n.query_start) for n in lst], False)

    # reference aln.cpp:651-653,712-713: the window and BOTH edges are
    # float32, and the int projected starts convert to float32 in every
    # compare — coordinates past 2^24 bp round (the 1e-6 epsilon breaks
    # promote back to double)
    window = f32_window(mu, sigma, 10)
    for nam1 in nams1:
        nam1_val = max(0, nam1.ref_start - nam1.query_start)
        if nam1.is_rc:
            lst = nams2_sorted[0]
            L_val = F32(F32(nam1_val) - window)
            R_val = F32(nam1_val)
            # first index with val > L_val
            lo, hi, ans_pos = 0, len(lst) - 1, len(lst)
            while lo <= hi:
                mid = (lo + hi) // 2
                now_val = max(0, lst[mid].ref_start - lst[mid].query_start)
                if F32(now_val) > L_val:
                    hi = mid - 1
                    ans_pos = mid
                else:
                    lo = mid + 1
            for idx in range(ans_pos, len(lst)):
                nam2 = lst[idx]
                joint_hits = nam1.n_hits + nam2.n_hits
                if nam1.ref_id != nam2.ref_id:
                    continue
                a = max(0, nam1.ref_start - nam1.query_start)
                b = max(0, nam2.ref_start - nam2.query_start)
                if b > float(R_val) - 1e-6:
                    break
                r2_r1 = (a - b >= 0) and (F32(a - b) < window)
                if r2_r1:
                    joint_nam_scores.append(NamPair(joint_hits, nam1, nam2))
                    added_n1.add(nam1.nam_id)
                    added_n2.add(nam2.nam_id)
        else:
            lst = nams2_sorted[1]
            L_val = F32(nam1_val)
            R_val = F32(F32(nam1_val) + window)
            # first index with val >= L_val
            lo, hi, ans_pos = 0, len(lst) - 1, len(lst)
            while lo <= hi:
                mid = (lo + hi) // 2
                now_val = max(0, lst[mid].ref_start - lst[mid].query_start)
                if F32(now_val) >= L_val:
                    hi = mid - 1
                    ans_pos = mid
                else:
                    lo = mid + 1
            for idx in range(ans_pos, len(lst)):
                nam2 = lst[idx]
                joint_hits = nam1.n_hits + nam2.n_hits
                if nam1.ref_id != nam2.ref_id:
                    continue
                a = max(0, nam1.ref_start - nam1.query_start)
                b = max(0, nam2.ref_start - nam2.query_start)
                if b >= float(R_val) - 1e-6:
                    break
                r1_r2 = (b - a >= 0) and (F32(b - a) < window)
                if r1_r2:
                    joint_nam_scores.append(NamPair(joint_hits, nam1, nam2))
                    added_n1.add(nam1.nam_id)
                    added_n2.add(nam2.nam_id)

    # high-scoring unpaired R1 NAMs (dummy partner has ref_start == -1)
    if nams1:
        best_joint_hits1 = best_joint_hits if best_joint_hits > 0 else nams1[0].n_hits
        for nam1 in nams1:
            if nam1.n_hits < best_joint_hits1 // 2:
                break
            if nam1.nam_id in added_n1:
                continue
            joint_nam_scores.append(NamPair(nam1.n_hits, nam1, Nam(ref_start=-1)))

    if nams2:
        best_joint_hits2 = best_joint_hits if best_joint_hits > 0 else nams2[0].n_hits
        for nam2 in nams2:
            if nam2.n_hits < best_joint_hits2 // 2:
                break
            if nam2.nam_id in added_n2:
                continue
            joint_nam_scores.append(NamPair(nam2.n_hits, Nam(ref_start=-1), nam2))

    introsort(joint_nam_scores, [p.score for p in joint_nam_scores], True)
    return joint_nam_scores


def has_shared_substring(read_seq: bytes, ref_seq: bytes, k: int) -> bool:
    """reference src/aln.cpp:1002-1013"""
    sub_size = 2 * k // 3
    step_size = k // 3
    i = 0
    while i + sub_size < len(read_seq):
        if read_seq[i : i + sub_size] in ref_seq:
            return True
        i += step_size
    return False


def rescue_mate(
    aligner: Aligner,
    nam: Nam,
    references: References,
    read: Read,
    mu: float,
    sigma: float,
    k: int,
) -> Alignment:
    """Windowed alignment of the unplaced mate near its partner's NAM
    (reference src/aln.cpp:1079-1143)."""
    read_len = read.size()
    w5 = f32_window(mu, sigma, 5)  # float32 like the reference's int=float
    if nam.is_rc:
        r_tmp = read.seq
        a = int(F32(F32(nam.ref_start - nam.query_start) - w5))
        b = nam.ref_start - nam.query_start + read_len // 2
    else:
        r_tmp = read.rc
        a = nam.ref_end + (read_len - nam.query_end) - read_len // 2
        b = int(F32(F32(nam.ref_end + (read_len - nam.query_end)) + w5))

    ref_len = references.lengths[nam.ref_id]
    ref_start = max(0, min(a, ref_len))
    ref_end = min(ref_len, max(0, b))

    if ref_end < ref_start + k:
        return Alignment(
            cigar=Cigar(), edit_distance=read_len, score=0, ref_start=0,
            is_rc=nam.is_rc, ref_id=nam.ref_id, is_unaligned=True,
        )
    ref_segm = references.sequences[nam.ref_id][ref_start:ref_end]

    if not has_shared_substring(r_tmp, ref_segm, k):
        return Alignment(
            cigar=Cigar(), edit_distance=read_len, score=0, ref_start=0,
            is_rc=nam.is_rc, ref_id=nam.ref_id, is_unaligned=True,
        )
    info = aligner.align(r_tmp, ref_segm)
    return Alignment(
        cigar=info.cigar,
        edit_distance=info.edit_distance,
        score=info.sw_score,
        ref_start=ref_start + info.ref_start,
        is_rc=not nam.is_rc,
        ref_id=nam.ref_id,
        is_unaligned=info.cigar.empty(),
        length=info.ref_span(),
    )


def get_best_scoring_pairs(
    alignments1: List[Alignment], alignments2: List[Alignment], mu: float, sigma: float
) -> List[ScoredAlignmentPair]:
    """reference src/aln.cpp:536-558"""
    pairs = []
    w4 = f32_window(mu, sigma, 4)
    for a1 in alignments1:
        for a2 in alignments2:
            # reference: `float dist = abs(...)` — rounds past 2^24
            dist = F32(abs(a1.ref_start - a2.ref_start))
            score = float(a1.score + a2.score)
            if (a1.is_rc != a2.is_rc) and (dist < w4):
                score += float(logf(normal_pdf(float(dist), mu, sigma)))
            else:
                score -= 10
            pairs.append(ScoredAlignmentPair(score, a1, a2))
    return pairs


def deduplicate_scored_pairs(pairs: List[ScoredAlignmentPair]) -> None:
    """reference src/aln.cpp:1149-1171 (in-place, keeps first of each run)."""
    prev = (
        pairs[0].alignment1.ref_start,
        pairs[0].alignment2.ref_start,
        pairs[0].alignment1.ref_id,
        pairs[0].alignment2.ref_id,
    )
    j = 1
    for i in range(1, len(pairs)):
        cur = (
            pairs[i].alignment1.ref_start,
            pairs[i].alignment2.ref_start,
            pairs[i].alignment1.ref_id,
            pairs[i].alignment2.ref_id,
        )
        if cur != prev:
            prev = cur
            pairs[j] = pairs[i]
            j += 1
    del pairs[j:]


def pick_random_top_pair(high_scores: List[ScoredAlignmentPair], random_engine: MinstdRand) -> None:
    """reference src/aln.cpp:1177-1193"""
    i = 1
    while i < len(high_scores) and high_scores[i].score == high_scores[0].score:
        i += 1
    if i > 1:
        random_index = uniform_int(random_engine, 0, i - 1)
        if random_index != 0:
            high_scores[0], high_scores[random_index] = (
                high_scores[random_index],
                high_scores[0],
            )


def joint_mapq_from_high_scores(pairs: List[ScoredAlignmentPair]) -> Tuple[int, int]:
    """reference src/aln.cpp:506-527"""
    if len(pairs) <= 1:
        return 60, 60
    score1 = pairs[0].score
    score2 = pairs[1].score
    if score1 == score2:
        return 0, 0
    diff = int(score1 - score2)
    if score1 > 0 and score2 > 0:
        mapq = min(60, diff)
    elif score1 > 0 and score2 <= 0:
        mapq = 60
    else:
        mapq = 1
    return mapq, mapq


def rescue_read(
    read2: Read,  # read to be rescued
    read1: Read,  # read that has NAMs
    aligner: Aligner,
    references: References,
    nams1: List[Nam],
    max_tries: int,
    dropoff: float,
    details: List[Details],
    k: int,
    mu: float,
    sigma: float,
    max_secondary: int,
    secondary_dropoff: float,
    sam: Sam,
    record1: SamRecord,
    record2: SamRecord,
    swap_r1r2: bool,
    random_engine: MinstdRand,
) -> None:
    """reference src/aln.cpp:1249-1358"""
    n_max1 = nams1[0]
    tries = 0
    alignments1: List[Alignment] = []
    alignments2: List[Alignment] = []
    for nam in nams1:
        score_dropoff1 = nam.n_hits / n_max1.n_hits
        if tries >= max_tries or score_dropoff1 < dropoff:
            break
        consistent_nam = reverse_nam_if_needed(nam, read1, references, k)
        details[0].nam_inconsistent += not consistent_nam
        alignment = extend_seed(aligner, nam, references, read1, consistent_nam)
        details[0].gapped += alignment.gapped
        alignments1.append(alignment)
        details[0].tried_alignment += 1

        a2 = rescue_mate(aligner, nam, references, read2, mu, sigma, k)
        details[1].mate_rescue += not a2.is_unaligned
        alignments2.append(a2)
        tries += 1

    introsort(alignments1, [a.score for a in alignments1], True)
    introsort(alignments2, [a.score for a in alignments2], True)
    high_scores = get_best_scoring_pairs(alignments1, alignments2, mu, sigma)
    introsort(high_scores, [p.score for p in high_scores], True)
    deduplicate_scored_pairs(high_scores)
    pick_random_top_pair(high_scores, random_engine)
    mapq1, mapq2 = joint_mapq_from_high_scores(high_scores)

    if max_secondary == 0:
        best = high_scores[0]
        a1, a2 = best.alignment1, best.alignment2
        if swap_r1r2:
            # note: the reference does NOT swap the details array here
            sam.add_pair(
                a2, a1, record2, record1, read2.rc, read1.rc, mapq2, mapq1,
                is_proper_pair(a2, a1, mu, sigma), True, (details[0], details[1]),
            )
        else:
            sam.add_pair(
                a1, a2, record1, record2, read1.rc, read2.rc, mapq1, mapq2,
                is_proper_pair(a1, a2, mu, sigma), True, (details[0], details[1]),
            )
    else:
        max_out = min(len(high_scores), max_secondary)
        is_primary = True
        # rescue_read keeps DOUBLE scores here (reference aln.cpp:1327
        # `auto s_max`), unlike align_PE's explicit `float s_max`
        s_max = high_scores[0].score
        for i in range(max_out):
            if i > 0:
                is_primary = False
                mapq1 = 0
                mapq2 = 0
            pair = high_scores[i]
            a1, a2 = pair.alignment1, pair.alignment2
            if s_max - pair.score < secondary_dropoff:
                if swap_r1r2:
                    sam.add_pair(
                        a2, a1, record2, record1, read2.rc, read1.rc, mapq2, mapq1,
                        is_proper_pair(a2, a1, mu, sigma), is_primary,
                        (details[1], details[0]),
                    )
                else:
                    sam.add_pair(
                        a1, a2, record1, record2, read1.rc, read2.rc, mapq1, mapq2,
                        is_proper_pair(a1, a2, mu, sigma), is_primary,
                        (details[0], details[1]),
                    )
            else:
                break


def align_PE(
    aligner: Aligner,
    sam: Sam,
    nams1: List[Nam],
    nams2: List[Nam],
    record1: SamRecord,
    record2: SamRecord,
    k: int,
    references: References,
    details: List[Details],
    dropoff: float,
    isize_est: InsertSizeDistribution,
    max_tries: int,
    max_secondary: int,
    random_engine: MinstdRand,
) -> None:
    """reference src/aln.cpp:1582-1823"""
    mu = isize_est.mu
    sigma = isize_est.sigma
    read1 = Read(record1.seq)
    read2 = Read(record2.seq)
    secondary_dropoff = 2 * aligner.parameters.mismatch + aligner.parameters.gap_open

    if not nams1 and not nams2:
        sam.add_unmapped_pair(record1, record2)
        return

    if nams1 and not nams2:
        rescue_read(
            read2, read1, aligner, references, nams1, max_tries, dropoff, details,
            k, mu, sigma, max_secondary, secondary_dropoff, sam, record1, record2,
            False, random_engine,
        )
        return

    if not nams1 and nams2:
        rescue_read(
            read1, read2, aligner, references, nams2, max_tries, dropoff, details,
            k, mu, sigma, max_secondary, secondary_dropoff, sam, record2, record1,
            True, random_engine,
        )
        return

    # typical case: both reads map uniquely and form a proper pair
    if (
        top_dropoff(nams1) < dropoff
        and top_dropoff(nams2) < dropoff
        and is_proper_nam_pair(nams1[0], nams2[0], mu, sigma)
    ):
        n_max1 = nams1[0]
        n_max2 = nams2[0]
        consistent_nam1 = reverse_nam_if_needed(n_max1, read1, references, k)
        details[0].nam_inconsistent += not consistent_nam1
        consistent_nam2 = reverse_nam_if_needed(n_max2, read2, references, k)
        details[1].nam_inconsistent += not consistent_nam2

        alignment1 = extend_seed(aligner, n_max1, references, read1, consistent_nam1)
        details[0].tried_alignment += 1
        details[0].gapped += alignment1.gapped
        alignment2 = extend_seed(aligner, n_max2, references, read2, consistent_nam2)
        details[1].tried_alignment += 1
        details[1].gapped += alignment2.gapped
        mapq1 = get_mapq(nams1, n_max1)
        mapq2 = get_mapq(nams2, n_max2)
        is_proper = is_proper_pair(alignment1, alignment2, mu, sigma)
        sam.add_pair(
            alignment1, alignment2, record1, record2, read1.rc, read2.rc,
            mapq1, mapq2, is_proper, True, (details[0], details[1]),
        )
        if (
            isize_est.sample_size < 400
            and alignment1.edit_distance + alignment2.edit_distance < 3
            and is_proper
        ):
            isize_est.update(abs(alignment1.ref_start - alignment2.ref_start))
        return

    # full search for the highest-scoring pair
    joint_nam_scores = get_best_scoring_nam_pairs(nams1, nams2, mu, sigma)
    is_aligned1: Dict[int, Alignment] = {}
    is_aligned2: Dict[int, Alignment] = {}

    n1_max = nams1[0]
    consistent_nam1 = reverse_nam_if_needed(n1_max, read1, references, k)
    details[0].nam_inconsistent += not consistent_nam1
    a1_indv_max = extend_seed(aligner, n1_max, references, read1, consistent_nam1)
    is_aligned1[n1_max.nam_id] = a1_indv_max
    details[0].tried_alignment += 1
    details[0].gapped += a1_indv_max.gapped

    n2_max = nams2[0]
    consistent_nam2 = reverse_nam_if_needed(n2_max, read2, references, k)
    details[1].nam_inconsistent += not consistent_nam2
    a2_indv_max = extend_seed(aligner, n2_max, references, read2, consistent_nam2)
    is_aligned2[n2_max.nam_id] = a2_indv_max
    details[1].tried_alignment += 1
    details[1].gapped += a2_indv_max.gapped

    high_scores: List[ScoredAlignmentPair] = []
    max_score = joint_nam_scores[0].score
    for pair in joint_nam_scores:
        score_, n1, n2 = pair.score, pair.nam1, pair.nam2
        score_dropoff = score_ / max_score
        if len(high_scores) >= max_tries or score_dropoff < dropoff:
            break

        # a1: compute, fetch from cache, or rescue from the partner's NAM
        if n1.ref_start >= 0:
            if n1.nam_id in is_aligned1:
                a1 = is_aligned1[n1.nam_id]
            else:
                consistent_nam = reverse_nam_if_needed(n1, read1, references, k)
                details[0].nam_inconsistent += not consistent_nam
                a1 = extend_seed(aligner, n1, references, read1, consistent_nam)
                is_aligned1[n1.nam_id] = a1
                details[0].tried_alignment += 1
                details[0].gapped += a1.gapped
        else:
            details[1].nam_inconsistent += not reverse_nam_if_needed(
                n2, read2, references, k
            )
            a1 = rescue_mate(aligner, n2, references, read1, mu, sigma, k)
            details[0].mate_rescue += not a1.is_unaligned
            details[0].tried_alignment += 1
        if a1.score > a1_indv_max.score:
            a1_indv_max = a1

        if n2.ref_start >= 0:
            if n2.nam_id in is_aligned2:
                a2 = is_aligned2[n2.nam_id]
            else:
                consistent_nam = reverse_nam_if_needed(n2, read2, references, k)
                details[1].nam_inconsistent += not consistent_nam
                a2 = extend_seed(aligner, n2, references, read2, consistent_nam)
                is_aligned2[n2.nam_id] = a2
                details[1].tried_alignment += 1
                details[1].gapped += a2.gapped
        else:
            details[0].nam_inconsistent += not reverse_nam_if_needed(
                n1, read1, references, k
            )
            a2 = rescue_mate(aligner, n1, references, read2, mu, sigma, k)
            details[1].mate_rescue += not a2.is_unaligned
            details[1].tried_alignment += 1
        if a2.score > a2_indv_max.score:
            a2_indv_max = a2

        w10 = f32_window(mu, sigma, 10)
        r1_r2 = a2.is_rc and (a1.ref_start <= a2.ref_start) and (
            F32(a2.ref_start - a1.ref_start) < w10
        )
        r2_r1 = a1.is_rc and (a2.ref_start <= a1.ref_start) and (
            F32(a1.ref_start - a2.ref_start) < w10
        )

        if r1_r2 or r2_r1:
            x = abs(a1.ref_start - a2.ref_start)
            lp = float(logf(normal_pdf(x, mu, sigma)))
            combined_score = float(a1.score) + float(a2.score) + max(
                float(np.float32(-20.0) + np.float32(0.001)), lp
            )
        else:
            combined_score = float(a1.score) + float(a2.score) - 20

        high_scores.append(ScoredAlignmentPair(combined_score, a1, a2))

    # highest individual scores as an additional candidate pair
    combined_score = float(a1_indv_max.score) + float(a2_indv_max.score) - 20
    high_scores.append(ScoredAlignmentPair(combined_score, a1_indv_max, a2_indv_max))

    introsort(high_scores, [p.score for p in high_scores], True)
    deduplicate_scored_pairs(high_scores)
    pick_random_top_pair(high_scores, random_engine)

    mapq1, mapq2 = joint_mapq_from_high_scores(high_scores)
    best = high_scores[0]
    alignment1, alignment2 = best.alignment1, best.alignment2
    if max_secondary == 0:
        is_proper = is_proper_pair(alignment1, alignment2, mu, sigma)
        sam.add_pair(
            alignment1, alignment2, record1, record2, read1.rc, read2.rc,
            mapq1, mapq2, is_proper, True, (details[0], details[1]),
        )
    else:
        max_out = min(len(high_scores), max_secondary)
        s_max = F32(best.score)  # reference: float s_max / float s_score
        is_primary = True
        for i in range(max_out):
            pair = high_scores[i]
            alignment1, alignment2 = pair.alignment1, pair.alignment2
            if i > 0:
                is_primary = False
                mapq1 = 255
                mapq2 = 255
            if float(F32(s_max - F32(pair.score))) < secondary_dropoff:
                is_proper = is_proper_pair(alignment1, alignment2, mu, sigma)
                sam.add_pair(
                    alignment1, alignment2, record1, record2, read1.rc, read2.rc,
                    mapq1, mapq2, is_proper, is_primary, (details[0], details[1]),
                )
            else:
                break


def get_best_map_location(
    nams1: List[Nam],
    nams2: List[Nam],
    isize_est: InsertSizeDistribution,
) -> Tuple[Nam, Nam]:
    """PAF-only joint location pick (reference src/aln.cpp:1826-1877)."""
    joint_nam_scores = get_best_scoring_nam_pairs(nams1, nams2, isize_est.mu, isize_est.sigma)
    best_nam1 = Nam(ref_start=-1)
    best_nam2 = Nam(ref_start=-1)
    if not joint_nam_scores:
        return best_nam1, best_nam2

    n1_joint_max = n2_joint_max = None
    score_joint = 0.0
    score_indiv = 0.0
    for t in joint_nam_scores:
        if t.nam1.ref_start >= 0 and t.nam2.ref_start >= 0:
            score_joint = t.nam1.score + t.nam2.score
            n1_joint_max = t.nam1
            n2_joint_max = t.nam2
            break

    if nams1:
        n1_indiv_max = nams1[0]
        score_indiv += n1_indiv_max.score - n1_indiv_max.score / 2.0
        best_nam1 = n1_indiv_max
    if nams2:
        n2_indiv_max = nams2[0]
        score_indiv += n2_indiv_max.score - n2_indiv_max.score / 2.0
        best_nam2 = n2_indiv_max
    if score_joint > score_indiv:
        best_nam1 = n1_joint_max
        best_nam2 = n2_joint_max

    if isize_est.sample_size < 400 and score_joint > score_indiv:
        isize_est.update(abs(n1_joint_max.ref_start - n2_joint_max.ref_start))
    return best_nam1, best_nam2


def align_PE_read(
    record1: SamRecord,
    record2: SamRecord,
    sam: Sam,
    outstring: List[str],
    statistics,
    isize_est: InsertSizeDistribution,
    aligner: Aligner,
    map_param: MappingParameters,
    index_parameters: IndexParameters,
    references: References,
    index: StrobemerIndex,
    random_engine: MinstdRand,
) -> List[Details]:
    """reference src/aln.cpp:2308-2370; PE reads are uppercased by the
    reference's callers (src/pc.cpp:410-411) — done here (idempotent)."""
    from ..utils.dna import to_uppercase

    record1.seq = to_uppercase(record1.seq)
    record2.seq = to_uppercase(record2.seq)
    details = [Details(), Details()]
    nams_pair: List[List[Nam]] = [[], []]
    for is_revcomp, record in enumerate((record1, record2)):
        nams_pair[is_revcomp] = get_nams_for_read(
            record.seq, index, index_parameters, map_param, random_engine,
            details[is_revcomp],
        )

    if not map_param.is_sam_out:
        nam1, nam2 = get_best_map_location(nams_pair[0], nams_pair[1], isize_est)
        output_hits_paf_PE(outstring, nam1, record1.name, references, len(record1.seq))
        output_hits_paf_PE(outstring, nam2, record2.name, references, len(record2.seq))
    else:
        align_PE(
            aligner, sam, nams_pair[0], nams_pair[1], record1, record2,
            index_parameters.syncmer.k, references, details,
            map_param.dropoff_threshold, isize_est, map_param.max_tries,
            map_param.max_secondary, random_engine,
        )
    return details
