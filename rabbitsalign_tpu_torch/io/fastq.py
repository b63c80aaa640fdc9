"""FASTQ/FASTA read input: chunked record reader for SE, PE and
interleaved inputs (role of reference src/fastq.{hpp,cpp} +
src/pc.cpp InputBuffer::read_records + RabbitFX chunking).

Records are parsed kseq-style: name is cut at the first whitespace.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional, Tuple

from .sam import SamRecord


def _open(path: str):
    return gzip.open(path, "rb") if str(path).endswith(".gz") else open(path, "rb")


def parse_fastx(path: str) -> Iterator[SamRecord]:
    """Yield records from a FASTA or FASTQ file (optionally gzipped)."""
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == b">":
            # FASTA
            name = f.readline().rstrip(b"\r\n")
            chunks: List[bytes] = []
            for raw in f:
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    yield _fasta_record(name, chunks)
                    name = line[1:]
                    chunks = []
                else:
                    chunks.append(line)
            yield _fasta_record(name, chunks)
        elif first == b"@":
            # FASTQ: 4 lines per record; the first '@' was already consumed
            name = f.readline().rstrip(b"\r\n")
            while True:
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                qual = f.readline().rstrip(b"\r\n")
                if not plus:
                    break
                if not plus.startswith(b"+"):
                    # wrapped-sequence or corrupt records: fail loudly
                    # instead of consuming the wrong line as quality
                    raise ValueError("malformed FASTQ record header")
                yield SamRecord(_cut_name(name), seq, qual)
                # skip blank lines at the header position (trailing
                # newlines are ubiquitous; same rule as the native
                # parser)
                while True:
                    header = f.readline()
                    if not header or header.rstrip(b"\r\n"):
                        break
                if not header:
                    break
                if not header.startswith(b"@"):
                    raise ValueError("malformed FASTQ record header")
                name = header[1:].rstrip(b"\r\n")
        else:
            raise ValueError(f"{path}: not a FASTA or FASTQ file")


def _cut_name(name: bytes) -> str:
    """QNAME tokenization, identical to the native parser's cut_name:
    truncate at the first ' ' or '\\t' (no leading-whitespace strip —
    '@ read1' has the empty QNAME in both layers)."""
    return name.split(b" ", 1)[0].split(b"\t", 1)[0].decode()


def _fasta_record(name: bytes, chunks: List[bytes]) -> SamRecord:
    return SamRecord(_cut_name(name), b"".join(chunks), b"")


def same_name(n1: str, n2: str) -> bool:
    """reference src/pc.cpp:23-36, exactly: names of length <= 2 compare
    plainly; otherwise equal prefixes, then a trailing /1 vs /2 pairs
    ONLY when the '/' separator is present (READ_A1/READ_A2 are two
    single-end reads in the reference, not a pair)."""
    if len(n1) != len(n2):
        return False
    if len(n1) <= 2:
        return n1 == n2
    if n1[:-1] != n2[:-1]:
        return False
    if n1[-2] == "/" and n1[-1] == "1" and n2[-1] == "2":
        return True
    return n1[-1] == n2[-1]


class InputBuffer:
    """Chunked record supply for SE / PE / interleaved inputs."""

    def __init__(self, path1: str, path2: str = "", chunk_size: int = 10000,
                 is_interleaved: bool = False):
        self.path1 = path1
        self.path2 = path2
        self.chunk_size = chunk_size
        self.is_interleaved = is_interleaved

    def chunks(self) -> Iterator[Tuple[int, List[SamRecord], List[SamRecord], List[SamRecord]]]:
        """Yield (chunk_index, records1, records2, records3) where records3
        holds unpaired records from interleaved input."""
        if self.path2:
            it1 = parse_fastx(self.path1)
            it2 = parse_fastx(self.path2)
            idx = 0
            while True:
                r1 = []
                r2 = []
                for _ in range(self.chunk_size):
                    try:
                        r1.append(next(it1))
                    except StopIteration:
                        # symmetric check: extra mates in file2 are an
                        # error too, not silently dropped
                        try:
                            next(it2)
                        except StopIteration:
                            break
                        raise ValueError(
                            "paired input files have different lengths")
                    try:
                        r2.append(next(it2))
                    except StopIteration:
                        raise ValueError("paired input files have different lengths")
                if not r1:
                    break
                yield idx, r1, r2, []
                idx += 1
        elif self.is_interleaved:
            # reference pc.cpp:90-92: each chunk is EXACTLY 2*chunk_size
            # RAW records (not chunk_size pairs), and pairing is
            # batch-local — a pair straddling the chunk boundary becomes
            # two single-end reads (distribute_interleaved's lookahead
            # carry is dead code: its scan loop always consumes the last
            # record into records3 first)
            it = parse_fastx(self.path1)
            idx = 0
            while True:
                raw: List[SamRecord] = []
                for _ in range(2 * self.chunk_size):
                    try:
                        raw.append(next(it))
                    except StopIteration:
                        break
                if not raw:
                    break
                r1: List[SamRecord] = []
                r2: List[SamRecord] = []
                r3: List[SamRecord] = []
                i = 0
                while i < len(raw):
                    if i + 1 < len(raw) and same_name(raw[i].name,
                                                      raw[i + 1].name):
                        r1.append(raw[i])
                        r2.append(raw[i + 1])
                        i += 2
                    else:
                        r3.append(raw[i])
                        i += 1
                yield idx, r1, r2, r3
                idx += 1
        else:
            it = parse_fastx(self.path1)
            idx = 0
            while True:
                r1 = []
                for _ in range(self.chunk_size):
                    try:
                        r1.append(next(it))
                    except StopIteration:
                        break
                if not r1:
                    break
                yield idx, r1, [], []
                idx += 1


def estimate_read_length(path1: str, path2: str = "",
                         interleaved: bool = False) -> int:
    """Average length of one read_records(500) chunk (reference
    src/readlen.cpp): 500 records for SE, 500 from each file for PE,
    and 2*500 raw records for interleaved input."""
    tot = 0
    n = 0
    limit1 = 1000 if interleaved else 500
    for path, limit in ((path1, limit1), (path2, 500)):
        if not path:
            continue
        for i, rec in enumerate(parse_fastx(path)):
            if i >= limit:
                break
            tot += len(rec.seq)
            n += 1
    if n == 0:
        return 150
    return tot // n
