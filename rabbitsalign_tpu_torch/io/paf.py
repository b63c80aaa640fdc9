"""PAF (mapping-only) output (reference src/paf.{hpp,cpp})."""

from __future__ import annotations

from typing import List

from ..chain.nams import Nam
from .fasta import References


def output_hits_paf_PE(
    out: List[str], n: Nam, query_name: str, references: References, read_len: int
) -> None:
    """reference src/paf.cpp:17-43"""
    if n.ref_start < 0:
        return
    out.append(
        f"{query_name}\t{read_len}\t{n.query_start}\t{n.query_end}\t"
        f"{'-' if n.is_rc else '+'}\t{references.names[n.ref_id]}\t"
        f"{references.lengths[n.ref_id]}\t{n.ref_start}\t{n.ref_end}\t"
        f"{n.n_hits}\t{n.ref_end - n.ref_start}\t255\n"
    )


def output_hits_paf(
    out: List[str], all_nams: List[Nam], query_name: str, references: References, read_len: int
) -> None:
    """reference src/paf.cpp:46-54 — single best hit only."""
    if not all_nams:
        return
    output_hits_paf_PE(out, all_nams[0], query_name, references, read_len)
