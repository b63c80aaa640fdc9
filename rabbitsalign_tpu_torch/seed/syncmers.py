"""Canonical closed-syncmer generation.

Reproduces the reference's `SyncmerIterator`
(reference src/randstrobes.cpp:57-118) bit-exactly, including its
tie-breaking of duplicated minimum s-mer hashes inside the k-mer window:

* while filling the very first window after a reset, the *leftmost*
  minimum wins (forward scan with strict `<`),
* when a new s-mer hash is strictly smaller than the tracked minimum it
  takes over,
* when the tracked minimum slides out of the window, the minimum is
  recomputed by scanning the window in reverse with strict `<`, so the
  *rightmost* minimum wins.

Two implementations are provided:

* :func:`syncmers_slow` — direct port of the stateful automaton
  (reference for tests).
* :func:`syncmers` — numpy-vectorized: s-mer/k-mer hashes and window
  minima are computed with O(k) vectorized passes; positions whose
  window minimum is *unique* are decided in closed form (identical to
  the automaton because the tracked minimum position always belongs to
  the argmin set), and only windows containing duplicated minima are
  resolved by running the automaton locally, re-synchronised at the
  nearest preceding unique-minimum window.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.dna import encode
from .hash import xxh64

_U64 = np.uint64
_UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _packed_mers(codes: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """For every position i (>= m-1), the 2-bit packed forward and
    reverse-complement m-mer ending at i, plus validity (no N inside).

    Returns (canonical_value uint64 array of len n, valid bool array).
    Positions i < m-1 are marked invalid.
    """
    n = codes.shape[0]
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    if n < m:
        return np.minimum(fwd, rc), np.zeros(n, dtype=bool)
    c = codes.astype(np.uint64)
    rc_c = _U64(3) - c  # only meaningful where codes < 4
    # fwd m-mer ending at i: sum_{j=0}^{m-1} codes[i-j] << (2*j)
    # rc m-mer ending at i:  sum_{j=0}^{m-1} (3-codes[i-j]) << (2*(m-1-j))
    for j in range(m):
        shift_f = _U64(2 * j)
        shift_r = _U64(2 * (m - 1 - j))
        if j == 0:
            fwd[m - 1:] |= c[m - 1:] << shift_f
            rc[m - 1:] |= rc_c[m - 1:] << shift_r
        else:
            fwd[m - 1:] |= c[m - 1 - j:n - j] << shift_f
            rc[m - 1:] |= rc_c[m - 1 - j:n - j] << shift_r
    # validity: no N in the last m bases
    isn = (codes >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(isn)])
    valid = np.zeros(n, dtype=bool)
    valid[m - 1:] = (cs[m:] - cs[: n - m + 1]) == 0
    return np.minimum(fwd, rc), valid


def syncmers_slow(seq: bytes | str, k: int, s: int, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Direct port of SyncmerIterator::next (reference src/randstrobes.cpp:57-118).

    Returns (positions int64, hashes uint64) of all canonical closed syncmers.
    """
    codes = encode(seq)
    n = codes.shape[0]
    kmask = _U64((1 << (2 * k)) - 1)
    smask = _U64((1 << (2 * s)) - 1)
    kshift = _U64((k - 1) * 2)
    sshift = _U64((s - 1) * 2)
    w = k - s + 1

    qs: list = []  # s-mer hashes in window
    qs_min_val = _UMAX
    qs_min_pos = -1
    l = 0
    xk0 = xk1 = xs0 = xs1 = _U64(0)
    out_pos = []
    out_hash = []
    with np.errstate(over="ignore"):
        for i in range(n):
            c = int(codes[i])
            if c < 4:
                xk0 = ((xk0 << _U64(2)) | _U64(c)) & kmask
                xk1 = (xk1 >> _U64(2)) | (_U64(3 - c) << kshift)
                xs0 = ((xs0 << _U64(2)) | _U64(c)) & smask
                xs1 = (xs1 >> _U64(2)) | (_U64(3 - c) << sshift)
                l += 1
                if l < s:
                    continue
                ys = min(xs0, xs1)
                hash_s = xxh64(ys)
                qs.append(hash_s)
                if len(qs) < w:
                    continue
                if len(qs) == w:
                    for j in range(len(qs)):
                        if qs[j] < qs_min_val:
                            qs_min_val = qs[j]
                            qs_min_pos = i - k + j + 1
                else:
                    qs.pop(0)
                    if qs_min_pos == i - k:  # popped the previous minimizer
                        qs_min_val = _UMAX
                        qs_min_pos = i - s + 1
                        for j in range(len(qs) - 1, -1, -1):  # rightmost wins
                            if qs[j] < qs_min_val:
                                qs_min_val = qs[j]
                                qs_min_pos = i - k + j + 1
                    elif hash_s < qs_min_val:
                        qs_min_val = hash_s
                        qs_min_pos = i - s + 1
                if qs_min_pos == i - k + t:  # occurs at t:th position in k-mer
                    yk = min(xk0, xk1)
                    out_pos.append(i - k + 1)
                    out_hash.append(xxh64(yk))
            else:
                qs_min_val = _UMAX
                qs_min_pos = -1
                l = 0
                xs0 = xs1 = xk0 = xk1 = _U64(0)
                qs.clear()
    return np.asarray(out_pos, dtype=np.int64), np.asarray(out_hash, dtype=np.uint64)


def _simulate_epoch(
    hs: np.ndarray, start: int, end: int, w: int, t: int, emit: np.ndarray
) -> None:
    """Run the reference min-queue automaton over one epoch of full windows.

    ``start``..``end`` (inclusive) are window-end indices of a maximal run
    of consecutive full windows; ``emit`` is overwritten for each of them.
    Mirrors SyncmerIterator state updates exactly.
    """
    # initial fill: forward scan, leftmost minimum (strict <)
    vals = hs[start - w + 1 : start + 1]
    min_val = _UMAX
    min_end = -1
    for j in range(w):
        if vals[j] < min_val:
            min_val = vals[j]
            min_end = start - w + 1 + j
    emit[start] = (min_end - (start - w + 1)) == (t - 1)
    for i in range(start + 1, end + 1):
        popped_end = i - w  # s-mer end position that slid out
        if min_end == popped_end:
            # rescan in reverse: rightmost minimum wins
            min_val = _UMAX
            min_end = i
            for j in range(w - 1, -1, -1):
                if hs[i - w + 1 + j] < min_val:
                    min_val = hs[i - w + 1 + j]
                    min_end = i - w + 1 + j
        elif hs[i] < min_val:
            min_val = hs[i]
            min_end = i
        emit[i] = (min_end - (i - w + 1)) == (t - 1)


def syncmers(seq: bytes | str, k: int, s: int, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized canonical closed syncmers, bit-exact with ``syncmers_slow``.

    Returns (positions int64 ascending, canonical k-mer hashes uint64).
    """
    codes = encode(seq)
    n = codes.shape[0]
    w = k - s + 1
    if n < k:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)

    smer_val, smer_valid = _packed_mers(codes, s)
    kmer_val, kmer_valid = _packed_mers(codes, k)
    hs = xxh64(smer_val)
    hs = np.where(smer_valid, hs, _UMAX)  # invalid -> +inf sentinel

    # window of the k-mer ending at i covers s-mer end positions i-w+1..i
    # stack shifted views: vals[i, j] = hs[i-w+1+j]
    # full[i] = kmer_valid[i] (all k bases non-N <=> all w s-mers valid)
    full = kmer_valid

    # sliding min / leftmost argmin / rightmost argmin over width w
    minval = np.full(n, _UMAX, dtype=np.uint64)
    left_arg = np.zeros(n, dtype=np.int32)
    right_arg = np.zeros(n, dtype=np.int32)
    # process in w passes
    for j in range(w):
        # hs at offset j within window ending at i -> hs[i-w+1+j]
        shifted = np.full(n, _UMAX, dtype=np.uint64)
        lo = w - 1 - j
        if lo == 0:
            shifted = hs
        else:
            shifted[lo:] = hs[:-lo] if lo else hs
        lt = shifted < minval
        eq = shifted == minval
        left_arg = np.where(lt, j, left_arg)
        right_arg = np.where(lt | eq, j, right_arg)
        minval = np.minimum(minval, shifted)

    dup = full & (left_arg != right_arg)

    # epoch starts: first full window of a maximal run of full windows
    prev_full = np.zeros(n, dtype=bool)
    prev_full[1:] = full[:-1]
    epoch_start = full & ~prev_full

    # closed-form emission: unique-minimum windows (and epoch starts, whose
    # fill scan uses the leftmost tie-break) emit iff leftmost argmin == t-1
    emit = full & (left_arg == t - 1)
    # Epochs containing any non-epoch-start duplicated-minimum window are
    # replayed through the exact automaton (rare: requires repeated s-mers
    # within one k-mer window, e.g. poly-A runs).
    need_sim = dup & ~epoch_start
    if np.any(need_sim):
        starts = np.flatnonzero(epoch_start)
        # epoch end: last full window before the next epoch start (or n-1)
        next_start = np.append(starts[1:], n)
        for st, nx in zip(starts, next_start):
            # epoch covers windows [st, en] where en = last full idx < nx
            en = nx - 1
            while en > st and not full[en]:
                en -= 1
            if np.any(need_sim[st : en + 1]):
                _simulate_epoch(hs, int(st), int(en), w, t, emit)

    idx = np.flatnonzero(emit)
    positions = (idx - k + 1).astype(np.int64)
    hashes = xxh64(kmer_val[idx])
    return positions, hashes
