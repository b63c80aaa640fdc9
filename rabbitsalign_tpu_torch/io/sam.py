"""SAM header (reference src/main.cpp:84-99). The records themselves are
written by the C++ engine in phase B."""

from __future__ import annotations

from .fasta import References


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
