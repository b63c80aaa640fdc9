"""Reference FASTA loading (reference src/refs.{hpp,cpp}).

Sequences are uppercased with the same `c & ~32` transform, names are cut
at the first space, plain or gzip-compressed files are accepted, and the
file must start with '>'.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import List

from ..utils.dna import to_uppercase


class InvalidFasta(RuntimeError):
    pass


@dataclass
class References:
    sequences: List[bytes] = field(default_factory=list)
    names: List[str] = field(default_factory=list)
    lengths: List[int] = field(default_factory=list)

    def add(self, name: str, sequence: bytes) -> None:
        self.names.append(name)
        self.sequences.append(sequence)
        self.lengths.append(len(sequence))

    def __len__(self) -> int:
        return len(self.sequences)

    def size(self) -> int:
        return len(self.sequences)

    def total_length(self) -> int:
        return sum(self.lengths)

    @staticmethod
    def from_fasta(path: str) -> "References":
        # gzip detected by magic bytes like the reference's zstr (an
        # extension check would reject a gzipped file named *.fa)
        with open(path, "rb") as probe:
            magic = probe.read(2)
        opener = gzip.open if magic == b"\x1f\x8b" else open
        refs = References()
        name = None
        chunks: List[bytes] = []
        with opener(path, "rb") as f:
            first = True
            for raw in f:
                # reference getline strips ONLY '\n': a CRLF file keeps
                # its '\r' bytes in names and sequences (where they act
                # as non-ACGT junk), and byte parity includes that
                line = raw.rstrip(b"\n")
                if first:
                    if not line.startswith(b">"):
                        raise InvalidFasta(
                            "FASTA file must begin with '>' character"
                        )
                    first = False
                if line.startswith(b">"):
                    if name is not None and chunks:
                        seq = to_uppercase(b"".join(chunks))
                        if len(seq) > 0:
                            refs.add(name, seq)
                    # cut at first space (reference src/refs.cpp:48)
                    header = line[1:].decode()
                    name = header.split(" ", 1)[0]
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None and chunks:
                seq = to_uppercase(b"".join(chunks))
                if len(seq) > 0:
                    refs.add(name, seq)
        if first:
            raise InvalidFasta("Cannot read from FASTA file")
        return refs
