"""SAM record construction (reference src/sam.{hpp,cpp}).

String-building writer with exact field/flag/TLEN semantics:
RNEXT '=' rules, unmapped-mate placement, NM/AS tags, /1 and /2 suffix
stripping, secondary records without SEQ/QUAL, optional detail tags.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..align.cigar import Cigar
from ..io.fasta import References

SAM_UNMAPPED_MAPQ = 0

# SamFlags (reference src/sam.hpp:47-60)
PAIRED = 1
PROPER_PAIR = 2
UNMAP = 4
MUNMAP = 8
REVERSE = 0x10
MREVERSE = 0x20
READ1 = 0x40
READ2 = 0x80
SECONDARY = 0x100
QCFAIL = 0x200
DUP = 0x400
SUPPLEMENTARY = 0x800

CIGAR_OPS_EQX = 0
CIGAR_OPS_M = 1


@dataclass
class SamRecord:
    """A sequencing record (the kseq++ KSeq equivalent)."""

    name: str
    seq: bytes
    qual: bytes = b""


# Keep the familiar name used throughout the mapping layer
KSeqRecord = SamRecord


@dataclass
class Alignment:
    """reference src/sam.hpp:12-25"""

    ref_id: int = 0
    ref_start: int = 0
    cigar: Cigar = field(default_factory=Cigar)
    edit_distance: int = 0
    global_ed: int = 0
    score: int = 0
    length: int = 0
    is_rc: bool = False
    is_unaligned: bool = False
    gapped: bool = False


@dataclass
class Details:
    """reference src/sam.hpp:67-75"""

    nam_rescue: bool = False
    nams: int = 0
    nam_inconsistent: int = 0
    mate_rescue: int = 0
    tried_alignment: int = 0
    gapped: int = 0


def strip_suffix(name: str) -> str:
    """Strip /1 or /2 (reference src/sam.cpp:30-41)."""
    if len(name) >= 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


class Sam:
    def __init__(
        self,
        references: References,
        cigar_ops: int = CIGAR_OPS_EQX,
        read_group_id: str = "",
        output_unmapped: bool = True,
        show_details: bool = False,
    ):
        self.parts: List[str] = []
        self.references = references
        self.cigar_ops = cigar_ops
        self.output_unmapped = output_unmapped
        self.show_details = show_details
        self.tail = "\n" if not read_group_id else f"\tRG:Z:{read_group_id}\n"

    def take(self) -> str:
        s = "".join(self.parts)
        self.parts = []
        return s

    def _cigar_string(self, cigar: Cigar) -> str:
        if cigar.empty():
            return "*"
        if self.cigar_ops == CIGAR_OPS_EQX:
            return str(cigar)
        return str(cigar.to_m())

    def _append_details(self, details: Details) -> None:
        self.parts.append(
            f"\tna:i:{details.nams}\tnr:i:{int(details.nam_rescue)}"
            f"\tal:i:{details.tried_alignment}\tga:i:{details.gapped}"
        )

    def _append_paired_details(self, details: Details) -> None:
        self.parts.append(f"\tmr:i:{details.mate_rescue}")

    def add_unmapped(self, record: SamRecord, flags: int = UNMAP) -> None:
        if not self.output_unmapped:
            return
        seq = record.seq.decode() if record.seq else "*"
        qual = record.qual.decode() if record.qual else "*"
        self.parts.append(
            f"{strip_suffix(record.name)}\t{flags}\t*\t0\t{SAM_UNMAPPED_MAPQ}\t*\t*\t0\t0\t{seq}\t{qual}"
        )
        self.parts.append(self.tail)

    def add_unmapped_mate(
        self, record: SamRecord, flags: int, mate_reference_name: str, mate_pos: int
    ) -> None:
        seq = record.seq.decode() if record.seq else "*"
        qual = record.qual.decode() if record.qual else "*"
        self.parts.append(
            f"{strip_suffix(record.name)}\t{flags}\t{mate_reference_name}\t{mate_pos + 1}"
            f"\t{SAM_UNMAPPED_MAPQ}\t*\t=\t{mate_pos + 1}\t0\t{seq}\t{qual}"
        )
        self.parts.append(self.tail)

    def add_unmapped_pair(self, r1: SamRecord, r2: SamRecord) -> None:
        self.add_unmapped(r1, PAIRED | UNMAP | MUNMAP | READ1)
        self.add_unmapped(r2, PAIRED | UNMAP | MUNMAP | READ2)

    def add(
        self,
        alignment: Alignment,
        record: SamRecord,
        sequence_rc: bytes,
        mapq: int,
        is_primary: bool,
        details: Details,
    ) -> None:
        """Single-end alignment (reference src/sam.cpp:119-138)."""
        if alignment.is_unaligned:
            # The reference asserts here; emit an unmapped record instead of
            # reading uninitialized fields (can only happen when every tried
            # alignment failed).
            self.add_unmapped(record)
            return
        flags = 0
        if alignment.is_rc:
            flags |= REVERSE
        if not is_primary:
            flags |= SECONDARY
            mapq = 255
        self.add_record(
            record.name,
            flags,
            self.references.names[alignment.ref_id],
            alignment.ref_start,
            mapq,
            alignment.cigar,
            "*",
            -1,
            0,
            record.seq,
            sequence_rc,
            record.qual,
            alignment.edit_distance,
            alignment.score,
            details,
        )

    def add_record(
        self,
        query_name: str,
        flags: int,
        reference_name: str,
        pos: int,
        mapq: int,
        cigar: Cigar,
        mate_reference_name: str,
        mate_pos: int,
        template_len: int,
        query_sequence: bytes,
        query_sequence_rc: bytes,
        qual: bytes,
        ed: int,
        aln_score: int,
        details: Details,
    ) -> None:
        """reference src/sam.cpp:141-213"""
        p = self.parts
        p.append(strip_suffix(query_name))
        p.append(f"\t{flags}\t{reference_name}\t{pos + 1}\t{mapq}\t")
        p.append(self._cigar_string(cigar))
        p.append(f"\t{mate_reference_name}\t{mate_pos + 1}\t{template_len}\t")

        if flags & SECONDARY:
            seq = b""
        elif flags & REVERSE:
            seq = query_sequence_rc
        else:
            seq = query_sequence
        p.append(seq.decode() if seq else "*")

        if not (flags & UNMAP):
            if flags & SECONDARY:
                q = b""
            elif flags & REVERSE:
                q = qual[::-1]
            else:
                q = qual
            p.append("\t")
            p.append(q.decode() if q else "*")
            p.append(f"\tNM:i:{ed}\tAS:i:{aln_score}")
        else:
            p.append("\t")
            p.append(qual.decode() if qual else "*")

        if self.show_details:
            self._append_details(details)
            if flags & PAIRED:
                self._append_paired_details(details)
        p.append(self.tail)

    def add_pair(
        self,
        alignment1: Alignment,
        alignment2: Alignment,
        record1: SamRecord,
        record2: SamRecord,
        read1_rc: bytes,
        read2_rc: bytes,
        mapq1: int,
        mapq2: int,
        is_proper: bool,
        is_primary: bool,
        details: Tuple[Details, Details],
    ) -> None:
        """reference src/sam.cpp:215-313"""
        f1 = PAIRED | READ1
        f2 = PAIRED | READ2
        if not is_primary:
            f1 |= SECONDARY
            f2 |= SECONDARY

        template_len1 = 0
        both_aligned = not alignment1.is_unaligned and not alignment2.is_unaligned
        if both_aligned and alignment1.ref_id == alignment2.ref_id:
            dist = alignment2.ref_start - alignment1.ref_start
            if dist > 0:
                template_len1 = dist + alignment2.length
            else:
                template_len1 = dist - alignment1.length
        if is_proper:
            f1 |= PROPER_PAIR
            f2 |= PROPER_PAIR

        pos1 = alignment1.ref_start
        if alignment1.is_unaligned:
            f1 |= UNMAP
            f2 |= MUNMAP
            pos1 = -1
            reference_name1 = "*"
        else:
            if alignment1.is_rc:
                f1 |= REVERSE
                f2 |= MREVERSE
            reference_name1 = self.references.names[alignment1.ref_id]

        pos2 = alignment2.ref_start
        if alignment2.is_unaligned:
            f2 |= UNMAP
            f1 |= MUNMAP
            pos2 = -1
            reference_name2 = "*"
        else:
            if alignment2.is_rc:
                f1 |= MREVERSE
                f2 |= REVERSE
            reference_name2 = self.references.names[alignment2.ref_id]

        mate_reference_name1 = reference_name1
        mate_reference_name2 = reference_name2
        if (
            not alignment1.is_unaligned
            and not alignment2.is_unaligned
            and alignment1.ref_id == alignment2.ref_id
        ) or (alignment1.is_unaligned != alignment2.is_unaligned):
            mate_reference_name1 = "="
            mate_reference_name2 = "="

        if alignment1.is_unaligned != alignment2.is_unaligned:
            if alignment1.is_unaligned:
                pos1 = pos2
            else:
                pos2 = pos1

        if alignment1.is_unaligned:
            self.add_unmapped_mate(record1, f1, reference_name2, pos2)
        else:
            self.add_record(
                record1.name, f1, reference_name1, alignment1.ref_start, mapq1,
                alignment1.cigar, mate_reference_name2, pos2, template_len1,
                record1.seq, read1_rc, record1.qual, alignment1.edit_distance,
                alignment1.score, details[0],
            )
        if alignment2.is_unaligned:
            self.add_unmapped_mate(record2, f2, reference_name1, pos1)
        else:
            self.add_record(
                record2.name, f2, reference_name2, alignment2.ref_start, mapq2,
                alignment2.cigar, mate_reference_name1, pos1, -template_len1,
                record2.seq, read2_rc, record2.qual, alignment2.edit_distance,
                alignment2.score, details[1],
            )


def is_proper_pair(alignment1: Alignment, alignment2: Alignment, mu: float, sigma: float) -> bool:
    """reference src/sam.cpp:315-325"""
    dist = alignment2.ref_start - alignment1.ref_start
    same_reference = alignment1.ref_id == alignment2.ref_id
    both_aligned = same_reference and not alignment1.is_unaligned and not alignment2.is_unaligned
    r1_r2 = (not alignment1.is_rc) and alignment2.is_rc and dist >= 0
    r2_r1 = (not alignment2.is_rc) and alignment1.is_rc and dist <= 0
    rel_orientation_good = r1_r2 or r2_r1
    # float32 window AND float32 distance, like the reference's
    # int <= float compare (coordinates past 2^24 round)
    import numpy as np

    f = np.float32
    insert_good = f(abs(dist)) <= f(f(mu) + f(6) * f(sigma))
    return both_aligned and insert_good and rel_orientation_good


def sam_header(references: References, read_group_id: str, read_group_fields, cmd_line: str) -> str:
    """reference src/main.cpp:84-99"""
    out = ["@HD\tVN:1.6\tSO:unsorted\n"]
    for name, length in zip(references.names, references.lengths):
        out.append(f"@SQ\tSN:{name}\tLN:{length}\n")
    if read_group_id:
        out.append(f"@RG\tID:{read_group_id}")
        for fld in read_group_fields:
            out.append(f"\t{fld}")
        out.append("\n")
    from .. import version_string

    out.append(
        f"@PG\tID:rabbitsalign\tPN:rabbitsalign\tVN:{version_string()}\tCL:{cmd_line}\n"
    )
    return "".join(out)
