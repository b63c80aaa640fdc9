"""DNA encoding utilities.

Encoding conventions follow the reference aligner
(reference src/randstrobes.cpp:14-31 and reference src/revcomp.hpp):
A/a -> 0, C/c -> 1, G/g -> 2, T/t/U/u -> 3, anything else -> 4 ("N").
"""

from __future__ import annotations

import numpy as np

# nucleotide -> 2-bit code table (256 entries), 4 = ambiguous
SEQ_NT4: np.ndarray = np.full(256, 4, dtype=np.uint8)
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _ch in _chars:
        SEQ_NT4[ord(_ch)] = _code

# reverse-complement table over ASCII: ACGTU (either case) map to the
# uppercase complement, everything else maps to 'N'
# (reference src/revcomp.hpp:11-28)
_COMP = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "a": "T", "c": "G", "g": "C", "t": "A", "u": "A",
}
REVCOMP_TABLE: np.ndarray = np.full(256, ord("N"), dtype=np.uint8)
for _i in range(256):
    _c = chr(_i)
    REVCOMP_TABLE[_i] = ord(_COMP.get(_c, "N"))


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0,1,2,3,4}."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4[np.frombuffer(seq, dtype=np.uint8)]


def reverse_complement(seq: bytes | str) -> bytes:
    """Reverse complement of an ASCII sequence (reference src/revcomp.hpp:30-56)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    return REVCOMP_TABLE[arr[::-1]].tobytes()


def to_uppercase(seq: bytes) -> bytes:
    """In-reference-style uppercase: c & ~32 (reference src/refs.cpp:9-15)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return (arr & np.uint8(~32 & 0xFF)).tobytes()


class Read:
    """A read and its reverse complement (reference src/revcomp.hpp Read)."""

    __slots__ = ("seq", "rc")

    def __init__(self, seq: bytes):
        self.seq = seq
        self.rc = reverse_complement(seq)

    def __len__(self) -> int:
        return len(self.seq)

    def size(self) -> int:
        return len(self.seq)
