"""DNA text utilities (reference src/refs.cpp)."""

from __future__ import annotations

import numpy as np


def to_uppercase(seq: bytes) -> bytes:
    """In-reference-style uppercase: c & ~32 (reference src/refs.cpp:9-15)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return (arr & np.uint8(~32 & 0xFF)).tobytes()
