"""DNA text utilities (reference src/refs.cpp; the 2-bit encoding of
reference src/randstrobes.cpp:14-31)."""

from __future__ import annotations

import numpy as np

# nucleotide -> 2-bit code table (256 entries), 4 = ambiguous:
# A/a -> 0, C/c -> 1, G/g -> 2, T/t/U/u -> 3, anything else -> 4 ("N")
SEQ_NT4: np.ndarray = np.full(256, 4, dtype=np.uint8)
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _ch in _chars:
        SEQ_NT4[ord(_ch)] = _code


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0,1,2,3,4}."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4[np.frombuffer(seq, dtype=np.uint8)]


def to_uppercase(seq: bytes) -> bytes:
    """In-reference-style uppercase: c & ~32 (reference src/refs.cpp:9-15)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return (arr & np.uint8(~32 & 0xFF)).tobytes()
