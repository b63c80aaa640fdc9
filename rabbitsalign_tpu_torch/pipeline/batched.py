"""Two-phase chunk mapping with batched (device) gapped extension.

Mirrors the reference's split-phase production path
(reference src/aln.cpp align_{SE,PE}_read_part / _last and the
part2_* helpers in src/pc.cpp): phase A runs seeding, NAM finding and all
decision logic that does not need gapped-alignment scores, recording a
todo list per read; pending gapped alignments are batched on the device;
phase B replays the scoring logic (early exits, reservoir sampling,
pairing) over the now-complete results.

RNG order matches the reference async workers: the per-chunk engine is
seeded with the chunk index, phase A consumes the NAM-shuffle draws for
the whole chunk, then phase B consumes the tie-breaking draws.

Known deviation from the reference: its software pipeline computes mate
rescue windows twice (at gather and store time) with an insert-size
estimate that may have advanced in between (src/pc.cpp overlaps phases
across chunks); we compute each window once, at phase-A time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..align.aligner import Aligner
from ..align.cigar import Cigar
from ..align.hamming import hamming_align, hamming_distance
from ..chain.nams import Nam
from ..chain.native_nams import native_available
from ..index.params import IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.paf import output_hits_paf, output_hits_paf_PE
from ..io.sam import Alignment, Details, Sam, SamRecord, is_proper_pair
from ..map.common import (
    F32,
    logf,
    InsertSizeDistribution,
    MappingParameters,
    f32_window,
    get_mapq,
    reverse_nam_if_needed,
    top_dropoff,
)
from ..map.pe import (
    ScoredAlignmentPair,
    deduplicate_scored_pairs,
    get_best_map_location,
    get_best_scoring_nam_pairs,
    get_best_scoring_pairs,
    has_shared_substring,
    is_proper_nam_pair,
    joint_mapq_from_high_scores,
    normal_pdf,
    pick_random_top_pair,
)
from ..map.randomness import MinstdRand, uniform_int
from ..map.se import get_nams_for_read
from ..ops.batch_extend import BatchAligner
from ..utils.dna import Read
from ..utils.sorting import introsort

INT_MAX = 2**31 - 1

from ..native import hamming_try as _native_hamming


@dataclass
class AlignTmpRes:
    """reference src/sam.hpp:27-45"""

    type: int = 0
    mapq1: int = 0
    mapq2: int = 0
    type4_loop_size: int = 0
    is_extend_seed: List[bool] = field(default_factory=list)
    consistent_nam: List[bool] = field(default_factory=list)
    is_read1: List[bool] = field(default_factory=list)
    type4_nams: List[Nam] = field(default_factory=list)
    todo_nams: List[Nam] = field(default_factory=list)
    done_align: List[bool] = field(default_factory=list)
    align_res: List[Optional[Alignment]] = field(default_factory=list)
    job_ids: List[int] = field(default_factory=list)  # -1 when done inline
    job_ref_start: List[int] = field(default_factory=list)
    job_qlen: List[int] = field(default_factory=list)


def extend_seed_part(
    tmp: AlignTmpRes,
    batch: BatchAligner,
    aligner: Aligner,
    nam: Nam,
    references: References,
    read: Read,
    consistent_nam: bool,
) -> bool:
    """reference src/aln.cpp:374-431 + job gathering
    (src/pc.cpp:214-242 part2_extend_seed_get_str)."""
    query = read.rc if nam.is_rc else read.seq
    ref = references.sequences[nam.ref_id]

    projected_ref_start = max(0, nam.ref_start - nam.query_start)
    projected_ref_end = min(nam.ref_end + len(query) - nam.query_end, len(ref))

    gapped = True
    tmp.todo_nams.append(nam)
    tmp.is_extend_seed.append(True)
    if projected_ref_end - projected_ref_start == len(query) and consistent_nam:
        segm = ref[projected_ref_start : projected_ref_start + len(query)]
        p = aligner.parameters
        # native fast path (distance gate + segment + cigar in one call)
        ham = _native_hamming(query, segm, p.match, p.mismatch, p.end_bonus)
        if ham is None:
            hd = hamming_distance(query, segm)
            if hd >= 0 and hd / len(query) < 0.05:
                info = hamming_align(query, segm, p.match, p.mismatch, p.end_bonus)
                ham = (
                    info.sw_score,
                    info.query_start,
                    info.query_end,
                    info.edit_distance,
                    info.cigar.ops,
                )
            else:
                ham = False
        if ham is not False:
            score, seg_start, seg_end, edits, cigar_ops = ham
            gapped = False
            softclipped = seg_start + (len(query) - seg_end)
            tmp.done_align.append(True)
            tmp.job_ids.append(-1)
            tmp.job_ref_start.append(0)
            tmp.job_qlen.append(len(query))
            tmp.align_res.append(
                Alignment(
                    cigar=Cigar(list(cigar_ops)),
                    edit_distance=edits,
                    global_ed=edits + softclipped,
                    score=score,
                    ref_start=projected_ref_start + seg_start,
                    length=seg_end - seg_start,
                    is_rc=nam.is_rc,
                    is_unaligned=False,
                    ref_id=nam.ref_id,
                    gapped=False,
                )
            )
            return False

    diff = abs(nam.ref_span() - nam.query_span())
    ext_left = min(50, projected_ref_start)
    ref_start = projected_ref_start - ext_left
    ext_right = min(50, len(ref) - nam.ref_end)
    ref_segm_size = read.size() + diff + ext_left + ext_right
    ref_segm = ref[ref_start : ref_start + ref_segm_size]
    tmp.done_align.append(False)
    tmp.job_ids.append(batch.submit(query, ref_segm))
    tmp.job_ref_start.append(ref_start)
    tmp.job_qlen.append(len(query))
    tmp.align_res.append(None)
    return True


def rescue_mate_part(
    tmp: AlignTmpRes,
    batch: BatchAligner,
    nam: Nam,
    references: References,
    read: Read,
    mu: float,
    sigma: float,
    k: int,
) -> bool:
    """reference src/aln.cpp:1015-1076 + src/pc.cpp:333-368. Returns True
    when the mate is (already known) unaligned."""
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

    tmp.todo_nams.append(nam)
    tmp.is_extend_seed.append(False)
    if ref_end < ref_start + k:
        tmp.done_align.append(True)
        tmp.job_ids.append(-1)
        tmp.job_ref_start.append(0)
        tmp.job_qlen.append(read_len)
        tmp.align_res.append(
            Alignment(
                cigar=Cigar(), edit_distance=read_len, score=0, ref_start=0,
                is_rc=nam.is_rc, ref_id=nam.ref_id, is_unaligned=True,
            )
        )
        return True
    ref_segm = references.sequences[nam.ref_id][ref_start:ref_end]
    if not has_shared_substring(r_tmp, ref_segm, k):
        tmp.done_align.append(True)
        tmp.job_ids.append(-1)
        tmp.job_ref_start.append(0)
        tmp.job_qlen.append(read_len)
        tmp.align_res.append(
            Alignment(
                cigar=Cigar(), edit_distance=read_len, score=0, ref_start=0,
                is_rc=nam.is_rc, ref_id=nam.ref_id, is_unaligned=True,
            )
        )
        return True
    tmp.done_align.append(False)
    tmp.job_ids.append(batch.submit(r_tmp, ref_segm))
    tmp.job_ref_start.append(ref_start)
    tmp.job_qlen.append(read_len)
    tmp.align_res.append(None)
    return False


def fill_results(tmp: AlignTmpRes, infos: List) -> None:
    """Convert batch AlignmentInfo results into Alignments
    (reference src/pc.cpp part2_extend_seed_store_res / part2_rescue_mate_store_res)."""
    for j in range(len(tmp.todo_nams)):
        if tmp.done_align[j]:
            continue
        info = infos[tmp.job_ids[j]]
        nam = tmp.todo_nams[j]
        ref_start = tmp.job_ref_start[j]
        if tmp.is_extend_seed[j]:
            softclipped = info.query_start + (tmp.job_qlen[j] - info.query_end)
            tmp.align_res[j] = Alignment(
                cigar=info.cigar,
                edit_distance=info.edit_distance,
                global_ed=info.edit_distance + softclipped,
                score=info.sw_score,
                ref_start=ref_start + info.ref_start,
                length=info.ref_span(),
                is_rc=nam.is_rc,
                is_unaligned=False,
                ref_id=nam.ref_id,
                gapped=True,
            )
        else:
            tmp.align_res[j] = Alignment(
                cigar=info.cigar,
                edit_distance=info.edit_distance,
                score=info.sw_score,
                ref_start=ref_start + info.ref_start,
                is_rc=not nam.is_rc,
                ref_id=nam.ref_id,
                is_unaligned=info.cigar.empty(),
                length=info.ref_span(),
            )


def align_SE_part(
    tmp: AlignTmpRes,
    batch: BatchAligner,
    aligner: Aligner,
    nams: List[Nam],
    record: SamRecord,
    read: Read,
    k: int,
    references: References,
    details: Details,
    dropoff_threshold: float,
    max_tries: int,
) -> None:
    """reference src/aln.cpp:95-130"""
    if not nams:
        tmp.type = 0
        return
    tries = 0
    n_max = nams[0]
    tmp.type = 4
    for nam in nams:
        score_dropoff = nam.n_hits / n_max.n_hits
        if tries >= max_tries or score_dropoff < dropoff_threshold:
            break
        consistent_nam = reverse_nam_if_needed(nam, read, references, k)
        tmp.consistent_nam.append(consistent_nam)
        tmp.is_read1.append(True)
        extend_seed_part(tmp, batch, aligner, nam, references, read, consistent_nam)
        tries += 1


def align_SE_last(
    tmp: AlignTmpRes,
    record: SamRecord,
    read: Read,
    sam: Sam,
    statistics,
    aligner: Aligner,
    map_param: MappingParameters,
    k: int,
    random_engine: MinstdRand,
) -> Details:
    """reference src/aln.cpp:132-260 align_SE_read_last"""
    details = Details()
    if tmp.type == 0:
        sam.add_unmapped(record)
        return details

    alignments: List[Alignment] = []
    tries = 0
    n_max = tmp.todo_nams[0]
    max_tries = map_param.max_tries
    max_secondary = map_param.max_secondary

    best_edit_distance = INT_MAX
    best_score = 0
    second_best_score = 0
    alignments_with_best_score = 0
    best_index = 0
    best_alignment = Alignment(is_unaligned=True)

    for i, nam in enumerate(tmp.todo_nams):
        score_dropoff = nam.n_hits / n_max.n_hits
        if (
            tries >= max_tries
            or (tries > 1 and best_edit_distance == 0)
            or score_dropoff < map_param.dropoff_threshold
        ):
            # (the reference uncounts pre-aligned jobs the break skips,
            # aln.cpp:175-180; here the batch jobs were counted on the
            # BatchAligner's INTERNAL aligner, not this one, so there is
            # nothing to compensate — the native engine, whose single
            # counter does include every job, performs the decrement)
            break
        consistent_nam = tmp.consistent_nam[i]
        details.nam_inconsistent += not consistent_nam
        alignment = tmp.align_res[i]
        details.tried_alignment += 1
        details.gapped += alignment.gapped

        if max_secondary > 0:
            alignments.append(alignment)
        if alignment.score >= best_score:
            second_best_score = best_score
            update_best = False
            if alignment.score > best_score:
                alignments_with_best_score = 1
                update_best = True
            else:
                alignments_with_best_score += 1
                if uniform_int(random_engine, 1, alignments_with_best_score) == 1:
                    update_best = True
            if update_best:
                best_score = alignment.score
                best_alignment = alignment
                best_index = tries
                if max_secondary == 0:
                    best_edit_distance = best_alignment.global_ed
        elif alignment.score > second_best_score:
            second_best_score = alignment.score
        tries += 1

    if best_score > 0:
        mapq = int((60.0 * (best_score - second_best_score) + best_score - 1) / best_score) & 0xFF
    else:
        mapq = 0
    sam.add(best_alignment, record, read.rc, mapq, True, details)

    if max_secondary == 0:
        return details

    if len(alignments) > 1:
        alignments[best_index], alignments[-1] = alignments[-1], alignments[best_index]
    if alignments:
        alignments.pop()
    introsort(alignments, [a.score for a in alignments], True)
    n = 0
    for alignment in alignments:
        if (
            n >= max_secondary
            or alignment.score - best_score
            > 2 * aligner.parameters.mismatch + aligner.parameters.gap_open
        ):
            break
        sam.add(alignment, record, read.rc, mapq, False, details)
        n += 1
    return details


def rescue_read_part(
    flag: int,
    tmp: AlignTmpRes,
    batch: BatchAligner,
    aligner: Aligner,
    read2: Read,
    read1: Read,
    references: References,
    nams1: List[Nam],
    max_tries: int,
    dropoff: float,
    details: List[Details],
    k: int,
    mu: float,
    sigma: float,
) -> None:
    """reference src/aln.cpp:1195-1243"""
    tmp.type = flag
    n_max1 = nams1[0]
    tries = 0
    for nam in nams1:
        score_dropoff1 = nam.n_hits / n_max1.n_hits
        if tries >= max_tries or score_dropoff1 < dropoff:
            break
        consistent_nam = reverse_nam_if_needed(nam, read1, references, k)
        details[0].nam_inconsistent += not consistent_nam
        tmp.is_read1.append(flag == 1)
        tmp.consistent_nam.append(consistent_nam)
        gapped = extend_seed_part(tmp, batch, aligner, nam, references, read1, consistent_nam)
        details[0].gapped += gapped
        details[0].tried_alignment += 1

        tmp.is_read1.append(flag != 1)
        rescue_mate_part(tmp, batch, nam, references, read2, mu, sigma, k)
        tries += 1


def rescue_read_last(
    tmp: AlignTmpRes,
    read2: Read,
    read1: Read,
    references: References,
    details: List[Details],
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
    """reference src/aln.cpp:1983-2080 rescue_read_last"""
    alignments1: List[Alignment] = []
    alignments2: List[Alignment] = []
    res_num = len(tmp.todo_nams)
    for i in range(0, res_num, 2):
        alignments1.append(tmp.align_res[i])
        alignments2.append(tmp.align_res[i + 1])
        details[1].mate_rescue += not tmp.align_res[i + 1].is_unaligned
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
            sam.add_pair(
                a2, a1, record2, record1, read2.rc, read1.rc, mapq2, mapq1,
                is_proper_pair(a2, a1, mu, sigma), True, (details[0], details[1]),
            )
        else:
            sam.add_pair(
                a1, a2, record1, record2, read1.rc, read2.rc, mapq1, mapq2,
                is_proper_pair(a1, a2, mu, sigma), True, (details[0], details[1]),
            )
        return
    max_out = min(len(high_scores), max_secondary)
    is_primary = True
    # rescue_read_last keeps DOUBLE scores here (reference aln.cpp:2049
    # `auto s_max`), unlike align_PE_read_last's explicit `float s_max`
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


def align_PE_part(
    tmp: AlignTmpRes,
    batch: BatchAligner,
    aligner: Aligner,
    nams1: List[Nam],
    nams2: List[Nam],
    record1: SamRecord,
    record2: SamRecord,
    read1: Read,
    read2: Read,
    k: int,
    references: References,
    details: List[Details],
    dropoff: float,
    isize_est: InsertSizeDistribution,
    max_tries: int,
) -> None:
    """reference src/aln.cpp:1372-1580"""
    mu = isize_est.mu
    sigma = isize_est.sigma

    if not nams1 and not nams2:
        tmp.type = 0
        return
    if nams1 and not nams2:
        rescue_read_part(
            1, tmp, batch, aligner, read2, read1, references, nams1, max_tries,
            dropoff, details, k, mu, sigma,
        )
        return
    if not nams1 and nams2:
        rescue_read_part(
            2, tmp, batch, aligner, read1, read2, references, nams2, max_tries,
            dropoff, details, k, mu, sigma,
        )
        return

    if (
        top_dropoff(nams1) < dropoff
        and top_dropoff(nams2) < dropoff
        and is_proper_nam_pair(nams1[0], nams2[0], mu, sigma)
    ):
        tmp.type = 3
        n_max1 = nams1[0]
        n_max2 = nams2[0]
        consistent_nam1 = reverse_nam_if_needed(n_max1, read1, references, k)
        details[0].nam_inconsistent += not consistent_nam1
        consistent_nam2 = reverse_nam_if_needed(n_max2, read2, references, k)
        details[1].nam_inconsistent += not consistent_nam2

        tmp.is_read1.append(True)
        tmp.consistent_nam.append(consistent_nam1)
        gapped1 = extend_seed_part(tmp, batch, aligner, n_max1, references, read1, consistent_nam1)
        details[0].tried_alignment += 1
        details[0].gapped += gapped1

        tmp.is_read1.append(False)
        tmp.consistent_nam.append(consistent_nam2)
        gapped2 = extend_seed_part(tmp, batch, aligner, n_max2, references, read2, consistent_nam2)
        details[1].tried_alignment += 1
        details[1].gapped += gapped2

        tmp.mapq1 = get_mapq(nams1, n_max1)
        tmp.mapq2 = get_mapq(nams2, n_max2)

        if not gapped1 and not gapped2:
            alignment1 = tmp.align_res[-2]
            alignment2 = tmp.align_res[-1]
            is_proper = is_proper_pair(alignment1, alignment2, mu, sigma)
            if (
                isize_est.sample_size < 400
                and alignment1.edit_distance + alignment2.edit_distance < 3
                and is_proper
            ):
                isize_est.update(abs(alignment1.ref_start - alignment2.ref_start))
        return

    tmp.type = 4
    joint_nam_scores = get_best_scoring_nam_pairs(nams1, nams2, mu, sigma)
    is_aligned1 = {}
    is_aligned2 = {}

    n1_max = nams1[0]
    consistent_nam1 = reverse_nam_if_needed(n1_max, read1, references, k)
    details[0].nam_inconsistent += not consistent_nam1
    tmp.is_read1.append(True)
    tmp.consistent_nam.append(consistent_nam1)
    gapped1 = extend_seed_part(tmp, batch, aligner, n1_max, references, read1, consistent_nam1)
    is_aligned1[n1_max.nam_id] = True
    details[0].tried_alignment += 1
    details[0].gapped += gapped1

    n2_max = nams2[0]
    consistent_nam2 = reverse_nam_if_needed(n2_max, read2, references, k)
    details[1].nam_inconsistent += not consistent_nam2
    tmp.is_read1.append(False)
    tmp.consistent_nam.append(consistent_nam2)
    gapped2 = extend_seed_part(tmp, batch, aligner, n2_max, references, read2, consistent_nam2)
    is_aligned2[n2_max.nam_id] = True
    details[1].tried_alignment += 1
    details[1].gapped += gapped2

    tmp.type4_loop_size = 0
    n_high_scores = 0
    max_score = joint_nam_scores[0].score
    for pair in joint_nam_scores:
        score_, n1, n2 = pair.score, pair.nam1, pair.nam2
        score_dropoff = score_ / max_score
        if n_high_scores >= max_tries or score_dropoff < dropoff:
            break
        tmp.type4_nams.append(n1)
        tmp.type4_nams.append(n2)
        tmp.type4_loop_size += 1

        if n1.ref_start >= 0:
            if n1.nam_id not in is_aligned1:
                consistent_nam = reverse_nam_if_needed(n1, read1, references, k)
                details[0].nam_inconsistent += not consistent_nam
                tmp.is_read1.append(True)
                tmp.consistent_nam.append(consistent_nam)
                gapped = extend_seed_part(tmp, batch, aligner, n1, references, read1, consistent_nam)
                is_aligned1[n1.nam_id] = True
                details[0].tried_alignment += 1
                details[0].gapped += gapped
        else:
            details[1].nam_inconsistent += not reverse_nam_if_needed(n2, read2, references, k)
            tmp.is_read1.append(True)
            tmp.consistent_nam.append(True)
            rescue_mate_part(tmp, batch, n2, references, read1, mu, sigma, k)
            details[0].tried_alignment += 1

        if n2.ref_start >= 0:
            if n2.nam_id not in is_aligned2:
                consistent_nam = reverse_nam_if_needed(n2, read2, references, k)
                details[1].nam_inconsistent += not consistent_nam
                tmp.is_read1.append(False)
                tmp.consistent_nam.append(consistent_nam)
                gapped = extend_seed_part(tmp, batch, aligner, n2, references, read2, consistent_nam)
                is_aligned2[n2.nam_id] = True
                details[1].tried_alignment += 1
                details[1].gapped += gapped
        else:
            details[0].nam_inconsistent += not reverse_nam_if_needed(n1, read1, references, k)
            tmp.is_read1.append(False)
            tmp.consistent_nam.append(True)
            rescue_mate_part(tmp, batch, n1, references, read2, mu, sigma, k)
            details[1].tried_alignment += 1

        n_high_scores += 1


def align_PE_last(
    tmp: AlignTmpRes,
    record1: SamRecord,
    record2: SamRecord,
    read1: Read,
    read2: Read,
    sam: Sam,
    isize_est: InsertSizeDistribution,
    map_param: MappingParameters,
    references: References,
    details: List[Details],
    random_engine: MinstdRand,
    aligner: Aligner,
) -> None:
    """reference src/aln.cpp:2083-2306 align_PE_read_last"""
    mu = isize_est.mu
    sigma = isize_est.sigma
    secondary_dropoff = 2 * aligner.parameters.mismatch + aligner.parameters.gap_open
    max_secondary = map_param.max_secondary

    if tmp.type == 0:
        sam.add_unmapped_pair(record1, record2)
        return
    if tmp.type == 1:
        rescue_read_last(
            tmp, read2, read1, references, details, mu, sigma, max_secondary,
            secondary_dropoff, sam, record1, record2, False, random_engine,
        )
        return
    if tmp.type == 2:
        rescue_read_last(
            tmp, read1, read2, references, details, mu, sigma, max_secondary,
            secondary_dropoff, sam, record2, record1, True, random_engine,
        )
        return
    if tmp.type == 3:
        alignment1 = tmp.align_res[0]
        alignment2 = tmp.align_res[1]
        is_proper = is_proper_pair(alignment1, alignment2, mu, sigma)
        sam.add_pair(
            alignment1, alignment2, record1, record2, read1.rc, read2.rc,
            tmp.mapq1, tmp.mapq2, is_proper, True, (details[0], details[1]),
        )
        # note: the reference's split path does NOT update the insert-size
        # estimator for gapped type-3 pairs here (src/aln.cpp:2132-2136)
        return

    # type 4
    pos = 0
    is_aligned1 = {}
    is_aligned2 = {}
    n1_max = tmp.todo_nams[pos]
    a1_indv_max = tmp.align_res[pos]
    is_aligned1[n1_max.nam_id] = a1_indv_max
    pos += 1
    n2_max = tmp.todo_nams[pos]
    a2_indv_max = tmp.align_res[pos]
    is_aligned2[n2_max.nam_id] = a2_indv_max
    pos += 1

    high_scores: List[ScoredAlignmentPair] = []
    for i in range(tmp.type4_loop_size):
        n1 = tmp.type4_nams[2 * i]
        n2 = tmp.type4_nams[2 * i + 1]

        if n1.ref_start >= 0:
            if n1.nam_id in is_aligned1:
                a1 = is_aligned1[n1.nam_id]
            else:
                a1 = tmp.align_res[pos]
                pos += 1
                is_aligned1[n1.nam_id] = a1
        else:
            a1 = tmp.align_res[pos]
            pos += 1
            details[0].mate_rescue += not a1.is_unaligned
        if a1.score > a1_indv_max.score:
            a1_indv_max = a1

        if n2.ref_start >= 0:
            if n2.nam_id in is_aligned2:
                a2 = is_aligned2[n2.nam_id]
            else:
                a2 = tmp.align_res[pos]
                pos += 1
                is_aligned2[n2.nam_id] = a2
        else:
            a2 = tmp.align_res[pos]
            pos += 1
            details[1].mate_rescue += not a2.is_unaligned
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
            # glibc logf: bit-exact with the reference's float log
            lp = float(logf(normal_pdf(x, mu, sigma)))
            combined_score = float(a1.score) + float(a2.score) + max(
                float(np.float32(-20.0) + np.float32(0.001)), lp
            )
        else:
            combined_score = float(a1.score) + float(a2.score) - 20
        high_scores.append(ScoredAlignmentPair(combined_score, a1, a2))

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


def _chunk_nams_native(seqs, index, index_parameters, map_param):
    """All-reads NAM finding through the engine; returns a list of
    (nams, used_rescue) per read, or None under RABBITSALIGN_TPU_NO_NATIVE."""
    if not native_available():
        return None
    from ..chain.native_nams import find_nams_chunk

    rescue_level = map_param.rescue_level if map_param.rescue_level > 1 else 0
    nams_per_read, _, used_rescue = find_nams_chunk(
        seqs, index, index_parameters, map_param.rescue_cutoff, rescue_level
    )
    return list(zip(nams_per_read, (bool(u) for u in used_rescue)))


def phase_a_chunk(
    records1: List[SamRecord],
    records2: List[SamRecord],
    records3: List[SamRecord],
    paf_out: List[str],
    isize_est: InsertSizeDistribution,
    aligner: Aligner,
    batch: BatchAligner,
    map_param: MappingParameters,
    index_parameters: IndexParameters,
    references: References,
    index: StrobemerIndex,
    random_engine: MinstdRand,
):
    """Phase A for one chunk: seeding + NAM finding + decision recording.
    Gapped extension jobs are submitted to `batch`; returns (work, n_reads)
    to be completed by phase_b_chunk after the batch is flushed."""
    from ..map.common import shuffle_top_nams

    k = index_parameters.syncmer.k
    is_pe = bool(records2)
    n_reads = 0

    # bulk NAM finding (native when available); PE reads are uppercased
    # like the reference (src/pc.cpp:410-411,1193-1194 — SE reads are,
    # deliberately, not)
    from ..utils.dna import to_uppercase

    all_seqs: List[bytes] = []
    if is_pe:
        for r1, r2 in zip(records1, records2):
            r1.seq = to_uppercase(r1.seq)
            r2.seq = to_uppercase(r2.seq)
            all_seqs.append(r1.seq)
            all_seqs.append(r2.seq)
    else:
        all_seqs.extend(r.seq for r in records1)
    all_seqs.extend(r.seq for r in records3)
    precomputed = _chunk_nams_native(all_seqs, index, index_parameters, map_param)
    pre_i = 0

    def next_nams(seq: bytes, details: Details) -> List[Nam]:
        nonlocal pre_i
        if precomputed is not None:
            nams, used_rescue = precomputed[pre_i]
            pre_i += 1
            details.nam_rescue = used_rescue
            details.nams = len(nams)
            introsort(nams, [n.score for n in nams], True)
            shuffle_top_nams(nams, random_engine)
            return nams
        return get_nams_for_read(
            seq, index, index_parameters, map_param, random_engine, details
        )

    work = []
    if is_pe:
        for r1, r2 in zip(records1, records2):
            details = [Details(), Details()]
            nams1 = next_nams(r1.seq, details[0])
            nams2 = next_nams(r2.seq, details[1])
            if not map_param.is_sam_out:
                nam1, nam2 = get_best_map_location(nams1, nams2, isize_est)
                output_hits_paf_PE(paf_out, nam1, r1.name, references, len(r1.seq))
                output_hits_paf_PE(paf_out, nam2, r2.name, references, len(r2.seq))
                work.append(None)
            else:
                read1 = Read(r1.seq)
                read2 = Read(r2.seq)
                tmp = AlignTmpRes()
                align_PE_part(
                    tmp, batch, aligner, nams1, nams2, r1, r2, read1, read2, k,
                    references, details, map_param.dropoff_threshold, isize_est,
                    map_param.max_tries,
                )
                work.append(("pe", r1, r2, read1, read2, tmp, details))
            n_reads += 2
    se_records = records1 if not is_pe else []
    se_records = list(se_records) + list(records3)
    for record in se_records:
        details = Details()
        nams = next_nams(record.seq, details)
        if not map_param.is_sam_out:
            output_hits_paf(paf_out, nams, record.name, references, len(record.seq))
            work.append(None)
        else:
            read = Read(record.seq)
            tmp = AlignTmpRes()
            align_SE_part(
                tmp, batch, aligner, nams, record, read, k, references, details,
                map_param.dropoff_threshold, map_param.max_tries,
            )
            work.append(("se", record, read, tmp, details))
        n_reads += 1
    return work, n_reads


def phase_b_chunk(
    work,
    infos,
    sam: Sam,
    statistics,
    isize_est: InsertSizeDistribution,
    aligner: Aligner,
    map_param: MappingParameters,
    index_parameters: IndexParameters,
    references: References,
    random_engine: MinstdRand,
) -> None:
    """Phase B: replay scoring/pairing over the completed batch results."""
    k = index_parameters.syncmer.k
    for item in work:
        if item is None:
            continue
        if item[0] == "pe":
            _, r1, r2, read1, read2, tmp, details = item
            fill_results(tmp, infos)
            align_PE_last(
                tmp, r1, r2, read1, read2, sam, isize_est, map_param, references,
                details, random_engine, aligner,
            )
            statistics.add_details(details[0])
            statistics.add_details(details[1])
        else:
            _, record, read, tmp, details = item
            fill_results(tmp, infos)
            last_details = align_SE_last(
                tmp, record, read, sam, statistics, aligner, map_param, k,
                random_engine,
            )
            details.nam_inconsistent += last_details.nam_inconsistent
            details.tried_alignment += last_details.tried_alignment
            details.gapped += last_details.gapped
            statistics.add_details(details)


def map_chunk_batched(
    records1: List[SamRecord],
    records2: List[SamRecord],
    records3: List[SamRecord],
    sam: Sam,
    paf_out: List[str],
    statistics,
    isize_est: InsertSizeDistribution,
    aligner: Aligner,
    batch: BatchAligner,
    map_param: MappingParameters,
    index_parameters: IndexParameters,
    references: References,
    index: StrobemerIndex,
    random_engine: MinstdRand,
) -> int:
    """Process one chunk in two phases with a batched extend in between.
    Returns the number of reads handled."""
    work, n_reads = phase_a_chunk(
        records1, records2, records3, paf_out, isize_est, aligner, batch,
        map_param, index_parameters, references, index, random_engine,
    )
    infos = batch.flush() if len(batch) else []
    phase_b_chunk(
        work, infos, sam, statistics, isize_est, aligner, map_param,
        index_parameters, references, random_engine,
    )
    return n_reads
