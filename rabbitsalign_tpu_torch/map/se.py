"""Single-end mapping core (reference src/aln.cpp:262-372 align_SE and
:2419-2467 align_SE_read)."""

from __future__ import annotations

from typing import List

from ..align.aligner import Aligner
from ..chain.nams import Nam, find_nams, find_nams_rescue
from ..index.params import IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.paf import output_hits_paf
from ..io.sam import Alignment, Details, Sam, SamRecord
from ..seed.randstrobes import randstrobes_query
from ..utils.dna import Read
from ..utils.sorting import introsort
from .common import MappingParameters, extend_seed, reverse_nam_if_needed, shuffle_top_nams
from .randomness import MinstdRand, uniform_int

INT_MAX = 2**31 - 1


def align_SE(
    aligner: Aligner,
    sam: Sam,
    nams: List[Nam],
    record: SamRecord,
    k: int,
    references: References,
    details: Details,
    dropoff_threshold: float,
    max_tries: int,
    max_secondary: int,
    random_engine: MinstdRand,
) -> None:
    """reference src/aln.cpp:262-372"""
    if not nams:
        sam.add_unmapped(record)
        return

    read = Read(record.seq)
    alignments: List[Alignment] = []
    tries = 0
    n_max = nams[0]

    best_edit_distance = INT_MAX
    best_score = 0
    second_best_score = 0
    alignments_with_best_score = 0
    best_index = 0
    best_alignment = Alignment(is_unaligned=True)

    for nam in nams:
        score_dropoff = nam.n_hits / n_max.n_hits
        if (
            tries >= max_tries
            or (tries > 1 and best_edit_distance == 0)
            or score_dropoff < dropoff_threshold
        ):
            break
        consistent_nam = reverse_nam_if_needed(nam, read, references, k)
        details.nam_inconsistent += not consistent_nam
        alignment = extend_seed(aligner, nam, references, read, consistent_nam)
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
                # reservoir sampling among ties
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
        return

    # secondary alignments (reference src/aln.cpp:348-372); the empty
    # guard matches the batched twin (unreachable after verify() bounds
    # -S/-M, where the reference hits UB)
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


def get_nams_for_read(
    seq: bytes,
    index: StrobemerIndex,
    index_parameters: IndexParameters,
    map_param: MappingParameters,
    random_engine: MinstdRand,
    details: Details,
) -> List[Nam]:
    """Seeding + NAM finding + optional rescue + score sort + tie shuffle —
    the common prologue of align_{SE,PE}_read (reference src/aln.cpp:2429-2454)."""
    query_randstrobes = randstrobes_query(seq, index_parameters)
    nonrepetitive_fraction, nams = find_nams(query_randstrobes, index)

    if map_param.rescue_level > 1:
        if not nams or nonrepetitive_fraction < 0.7:
            details.nam_rescue = True
            nams = find_nams_rescue(query_randstrobes, index, map_param.rescue_cutoff)

    details.nams = len(nams)
    introsort(nams, [n.score for n in nams], True)
    shuffle_top_nams(nams, random_engine)
    return nams


def align_SE_read(
    record: SamRecord,
    sam: Sam,
    outstring: List[str],
    statistics,
    aligner: Aligner,
    map_param: MappingParameters,
    index_parameters: IndexParameters,
    references: References,
    index: StrobemerIndex,
    random_engine: MinstdRand,
) -> Details:
    """reference src/aln.cpp:2419-2467"""
    details = Details()
    nams = get_nams_for_read(
        record.seq, index, index_parameters, map_param, random_engine, details
    )
    if not map_param.is_sam_out:
        output_hits_paf(outstring, nams, record.name, references, len(record.seq))
    else:
        align_SE(
            aligner, sam, nams, record, index_parameters.syncmer.k, references,
            details, map_param.dropoff_threshold, map_param.max_tries,
            map_param.max_secondary, random_engine,
        )
    return details
