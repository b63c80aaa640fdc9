"""CIGAR representation: vector of (length<<4 | op) packed uint32 values,
matching the reference (reference src/cigar.{hpp,cpp}) and BAM
conventions. Op codes: M I D N S H P = X  ->  0..8."""

from __future__ import annotations

from typing import Iterable, List

CIGAR_MATCH = 0
CIGAR_INS = 1
CIGAR_DEL = 2
CIGAR_N_SKIP = 3
CIGAR_SOFTCLIP = 4
CIGAR_HARDCLIP = 5
CIGAR_PAD = 6
CIGAR_EQ = 7
CIGAR_X = 8

OPS_STR = "MIDNSHP=X"
_OP_FROM_CHAR = {c: i for i, c in enumerate(OPS_STR)}


class Cigar:
    __slots__ = ("ops",)

    def __init__(self, ops: Iterable[int] | str | None = None):
        if ops is None:
            self.ops: List[int] = []
        elif isinstance(ops, str):
            self.ops = []
            self._parse(ops)
        else:
            self.ops = list(ops)

    def _parse(self, cig: str) -> None:
        """reference src/cigar.cpp:55-90, incl. its zero-count quirks: a
        bare '0' count is NOT consumed by the following op (it neither
        pushes nor resets, so '0M5I' folds the 0 into the next number and
        '0M' alone throws the trailing-number error)."""
        number = -1
        for c in cig:
            if c.isdigit():
                number = int(c) if number == -1 else number * 10 + int(c)
            else:
                if c == " ":
                    continue
                try:
                    op = _OP_FROM_CHAR[c]
                except KeyError:
                    raise ValueError("Invalid CIGAR operator")
                if number == -1:
                    self.push(op, 1)
                elif number > 0:
                    self.push(op, number)
                    number = -1
        if number != -1:
            raise ValueError("CIGAR must not end with a number")

    def empty(self) -> bool:
        return not self.ops

    def __bool__(self) -> bool:
        return bool(self.ops)

    def push(self, op: int, length: int) -> None:
        """Append with run merging (reference src/cigar.hpp:52-59)."""
        if not self.ops or (self.ops[-1] & 0xF) != op:
            self.ops.append((length << 4) | op)
        else:
            self.ops[-1] += length << 4

    def __iadd__(self, other: "Cigar") -> "Cigar":
        for op_len in other.ops:
            self.push(op_len & 0xF, op_len >> 4)
        return self

    def reverse(self) -> None:
        self.ops.reverse()

    def edit_distance(self) -> int:
        """Sum of I/D/X lengths (valid when only I, D, X, = are used)."""
        dist = 0
        for op_len in self.ops:
            op = op_len & 0xF
            if op in (CIGAR_INS, CIGAR_DEL, CIGAR_X):
                dist += op_len >> 4
        return dist

    def to_m(self) -> "Cigar":
        out = Cigar()
        for op_len in self.ops:
            op = op_len & 0xF
            length = op_len >> 4
            out.push(CIGAR_MATCH if op in (CIGAR_EQ, CIGAR_X) else op, length)
        return out

    def to_eqx(self, query: bytes, ref: bytes) -> "Cigar":
        """Replace M by =/X given the aligned sequences
        (reference src/cigar.cpp:20-45)."""
        i = j = 0
        out = Cigar()
        for op_len in self.ops:
            op = op_len & 0xF
            length = op_len >> 4
            if op == CIGAR_MATCH:
                for _ in range(length):
                    out.push(CIGAR_EQ if query[i] == ref[j] else CIGAR_X, 1)
                    i += 1
                    j += 1
            elif op == CIGAR_INS:
                out.push(op, length)
                i += length
            elif op == CIGAR_DEL:
                out.push(op, length)
                j += length
        return out

    def __str__(self) -> str:
        return "".join(f"{op_len >> 4}{OPS_STR[op_len & 0xF]}" for op_len in self.ops)

    def __repr__(self) -> str:
        return f"Cigar('{self}')"

    def __eq__(self, other) -> bool:
        return isinstance(other, Cigar) and self.ops == other.ops

    def copy(self) -> "Cigar":
        return Cigar(list(self.ops))


def compress_cigar(ops: str) -> str:
    """Run-length encode a string of single-op characters
    (reference src/cigar.cpp:92-110)."""
    out = []
    prev = None
    count = 0
    for op in ops:
        if prev is not None and op != prev:
            out.append(f"{count}{prev}")
            count = 0
        count += 1
        prev = op
    if prev is not None:
        out.append(f"{count}{prev}")
    return "".join(out)
