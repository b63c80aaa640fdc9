"""Per-thread mapping statistics (reference src/aln.hpp:13-56)."""

from __future__ import annotations

from dataclasses import dataclass

from ..io.sam import Details


@dataclass
class AlignmentStatistics:
    tot_read_file: float = 0.0
    tot_construct_strobemers: float = 0.0
    tot_find_nams: float = 0.0
    tot_time_rescue: float = 0.0
    tot_sort_nams: float = 0.0
    tot_extend: float = 0.0
    tot_write_file: float = 0.0
    n_reads: int = 0
    tot_aligner_calls: int = 0
    tot_rescued: int = 0
    tot_all_tried: int = 0
    inconsistent_nams: int = 0
    nam_rescue: int = 0

    def add_details(self, details: Details) -> None:
        self.nam_rescue += int(details.nam_rescue)
        self.tot_rescued += details.mate_rescue
        self.tot_all_tried += details.tried_alignment
        self.inconsistent_nams += details.nam_inconsistent

    def __iadd__(self, other: "AlignmentStatistics") -> "AlignmentStatistics":
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self
