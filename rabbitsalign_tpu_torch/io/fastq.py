"""Read-length estimation over FASTQ/FASTA input (reference
src/readlen.cpp). Mapping itself reads its input through the engine's
native chunked reader (native/engine.py NativeReader)."""

from __future__ import annotations

import gzip
from typing import Iterator


def _open(path: str):
    return gzip.open(path, "rb") if str(path).endswith(".gz") else open(path, "rb")


def _sequences(path: str) -> Iterator[bytes]:
    """Yield the sequence of every record of a FASTA or FASTQ file
    (optionally gzipped), with the record rules of the native parser."""
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == b">":
            f.readline()
            chunks = []
            for raw in f:
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    yield b"".join(chunks)
                    chunks = []
                else:
                    chunks.append(line)
            yield b"".join(chunks)
        elif first == b"@":
            # FASTQ: 4 lines per record; the first '@' was already consumed
            f.readline()
            while True:
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                f.readline()
                if not plus:
                    break
                if not plus.startswith(b"+"):
                    raise ValueError("malformed FASTQ record header")
                yield seq
                # blank lines at the header position are skipped
                while True:
                    header = f.readline()
                    if not header or header.rstrip(b"\r\n"):
                        break
                if not header:
                    break
                if not header.startswith(b"@"):
                    raise ValueError("malformed FASTQ record header")
        else:
            raise ValueError(f"{path}: not a FASTA or FASTQ file")


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
        for i, seq in enumerate(_sequences(path)):
            if i >= limit:
                break
            tot += len(seq)
            n += 1
    if n == 0:
        return 150
    return tot // n
