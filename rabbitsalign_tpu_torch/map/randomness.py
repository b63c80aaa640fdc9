"""Bit-exact reimplementation of the C++ randomness the reference relies
on for reproducible tie-breaking: std::minstd_rand, libstdc++'s
uniform_int_distribution (downscaling with rejection) and std::shuffle
(including the two-uniform-ints optimization). Validated against compiled
libstdc++ goldens (tests/golden_gen/rng_golden.cpp).

The reference seeds one engine per chunk with the chunk index
(reference src/pc.cpp:583,706) and consumes draws in
shuffle_top_nams / reservoir sampling / pick_random_top_pair.
"""

from __future__ import annotations

_M = 2147483647  # 2^31 - 1
_A = 48271


class MinstdRand:
    """std::minstd_rand: x <- x * 48271 mod (2^31 - 1); min()=1."""

    __slots__ = ("state",)

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, value: int) -> None:
        value %= _M
        self.state = value if value != 0 else 1

    def __call__(self) -> int:
        self.state = (self.state * _A) % _M
        return self.state

    MIN = 1
    MAX = _M - 1  # 2147483646


_URNGRANGE = MinstdRand.MAX - MinstdRand.MIN  # 2147483645


def uniform_int(g: MinstdRand, a: int, b: int) -> int:
    """libstdc++ uniform_int_distribution::operator() for urngrange >
    urange (always true here: ranges are tiny)."""
    urange = b - a
    assert _URNGRANGE > urange
    uerange = urange + 1
    scaling = _URNGRANGE // uerange
    past = uerange * scaling
    while True:
        ret = g() - MinstdRand.MIN
        if ret < past:
            break
    return ret // scaling + a


def shuffle(seq: list, g: MinstdRand) -> None:
    """libstdc++ std::shuffle. With minstd's range and small sequences the
    two-uniform-ints fast path is always taken."""
    n = len(seq)
    if n == 0:
        return
    urange = n
    if _URNGRANGE // urange >= urange:
        i = 1
        if n % 2 == 0:
            j = uniform_int(g, 0, 1)
            seq[i], seq[j] = seq[j], seq[i]
            i += 1
        while i < n:
            swap_range = i + 1
            # __gen_two_uniform_ints(swap_range, swap_range + 1, g)
            x = uniform_int(g, 0, swap_range * (swap_range + 1) - 1)
            p0 = x // (swap_range + 1)
            p1 = x % (swap_range + 1)
            seq[i], seq[p0] = seq[p0], seq[i]
            i += 1
            seq[i], seq[p1] = seq[p1], seq[i]
            i += 1
        return
    for i in range(1, n):
        j = uniform_int(g, 0, i)
        seq[i], seq[j] = seq[j], seq[i]
