"""Exact reimplementation of the SSW (striped Smith-Waterman) library
semantics used by the reference aligner (reference ext/ssw/ssw.c):

* forward pass: sw_sse2_byte first (16 lanes, biased saturating u8
  arithmetic); on saturation (max + bias >= 255) rerun as sw_sse2_word
  (8 lanes, i16) — exactly ssw_init's score_size=2 adaptive flow,
* reverse pass over the reversed prefixes (same lane width as the
  forward winner, terminate = score1) determines (ref_begin, read_begin),
* cigar from `banded_sw` over the clipped region, band doubling until the
  banded score reaches score1, with its exact direction-code tie-breaks.

The striped kernels are simulated FAITHFULLY, not idealized: ssw.c's
Farrar formulation is NOT the textbook DP. Its semantics include
(probed 2026-08 via tests/test_param_fuzz.py, minimal case
q=AGCNNCGT r=AGCCGT A3 B12 O4 E4 -> ssw 9, textbook 10):
  * insertion gaps open only from pre-insertion H values (the SWPS3
    "disallow adjacent insertion then deletion" revision: E is never
    updated from lazy-F-corrected H),
  * deletion states update from the MAIN-pass H (in-lane F only, no
    cross-lane corrections),
  * the lazy-F loop STOPS GLOBALLY at the first (round, stripe) where
    no lane has vF > max(H - gapO, 0) — cutting productive pure
    extensions that the textbook recurrence keeps,
  * lane geometry (segLen = ceil(readLen/lanes)) decides where in-lane
    main-pass propagation ends and prunable lazy propagation begins, so
    BYTE (16-lane) and WORD (8-lane) passes are semantically different
    programs — which is why both are simulated, adaptively like ssw.c.
The main pass is numpy-vectorized with the prefix-max formulation of
the in-lane F chain (exact for gap_open >= gap_extend, which the CLI
enforces); the lazy pass simulates lane vectors literally (it usually
terminates within a step or two). `banded_sw` is a literal port.

Zero-score edge case: ssw returns (score1=0, ref_begin=-1, ref_end=-1,
read_begin=0, read_end=0, cigar="1M"); reproduced verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cigar import CIGAR_DEL, CIGAR_INS, CIGAR_MATCH, Cigar

NEG_INF = -(1 << 30)


@dataclass
class SswResult:
    score1: int
    ref_begin: int
    ref_end: int
    read_begin: int
    read_end: int
    flag: int
    cigar: Cigar  # M/I/D ops over the clipped region (no soft clips)


def _striped_pass(q: np.ndarray, r: np.ndarray, A: int, B: int, O: int,
                  E: int, lanes: int, terminate: int):
    """Faithful simulation of ssw.c sw_sse2_byte (lanes=16) /
    sw_sse2_word (lanes=8) over code arrays (0..3 bases, 4=N).

    Returns (max, end_ref, end_read, overflowed) — `max` is the true
    (bias-free) score; `overflowed` mirrors the byte pass's
    max + bias >= 255 break (callers rerun in word mode). `terminate`
    stops the column loop when a column max equals it (the reverse-pass
    locate; pass a never-matching value for the forward pass).
    The ref direction flag of ssw.c is realized by the CALLER passing a
    reversed r (column work depends only on ref[i], so iterating a
    reversed array forward is the reversed iteration)."""
    m = int(q.shape[0])
    n = int(r.shape[0])
    if m == 0 or n == 0:  # empty input: nothing scores (seg would be 0)
        return 0, (-1 if lanes == 16 else 0), max(m - 1, 0), False
    byte_mode = lanes == 16
    bias = B if byte_mode else 0
    sat = 255 if byte_mode else 32767
    seg = (m + lanes - 1) // lanes

    # striped position map: stripe j, lane l -> read position j + l*seg
    idx = np.arange(seg)[:, None] + np.arange(lanes)[None, :] * seg
    valid = idx < m
    qs = np.where(valid, q[np.minimum(idx, m - 1)].astype(np.int32), -1)
    # profile net substitution per target code; PADDED cells score 0
    # (qP_byte stores `bias` there, qP_word stores 0 — both net 0)
    prof = np.empty((5, seg, lanes), np.int32)
    for c in range(5):
        prof[c] = np.where(valid, np.where((qs == c) & (qs < 4), A, -B), 0)

    H = np.zeros((seg, lanes), np.int32)
    Eb = np.zeros((seg, lanes), np.int32)
    Hmax = np.zeros((seg, lanes), np.int32)
    best = 0
    end_ref = -1 if byte_mode else 0
    end_read = m - 1
    overflow = False

    for i in range(n):
        sub = prof[r[i]]
        # diagonal: H(prev column) shifted one lane at the stripe seam
        diag = np.empty((seg, lanes), np.int32)
        diag[1:] = H[:-1]
        diag[0, 1:] = H[seg - 1, :-1]
        diag[0, 0] = 0
        # adds_ep{u8,i16} then (byte) subs_epu8 bias: saturate, debias
        hd = np.minimum(diag + sub + bias, sat)
        if byte_mode:
            hd = np.maximum(hd - bias, 0)
        # main pass, vectorized: the in-lane vF chain is a prefix-max
        # over H values EXCLUDING vF (exact for O >= E: reopening from
        # an F-valued H never beats extending, see module docstring)
        Hpre = np.maximum(hd, Eb)
        # F(j) = max_{j'<j} (openv(j') - (j-1-j')*E), clamped >= 0
        # (saturating u8/u16 decay): with w(j') = openv(j') + j'*E this
        # is cummax(w)[j-1] - (j-1)*E
        openv = np.maximum(Hpre - O, 0)
        dec = (np.arange(seg, dtype=np.int32) * E)[:, None]
        P = np.maximum.accumulate(openv + dec, axis=0)
        F = np.zeros((seg, lanes), np.int32)
        if seg > 1:
            F[1:] = np.maximum(P[:-1] - dec[:-1], 0)
        Hm = np.maximum(Hpre, F)
        Eb = np.maximum(np.maximum(Eb - E, 0), np.maximum(Hm - O, 0))
        vmaxcol = Hm.max(axis=0)  # per-lane column max so far
        Hnew = Hm
        # vF as it leaves the main pass: the chain evaluated one past
        # each lane's last stripe
        vF = np.maximum(P[seg - 1] - dec[seg - 1], 0)

        # lazy-F loop: global early stop, no E updates, no reopening
        done = False
        for _k in range(lanes):
            vF = np.concatenate(([0], vF[:-1]))
            if not vF.any():
                break
            for j in range(seg):
                row = np.maximum(Hnew[j], vF)
                Hnew[j] = row
                vmaxcol = np.maximum(vmaxcol, row)
                vho = np.maximum(row - O, 0)
                vF = np.maximum(vF - E, 0)
                if not (vF > vho).any():
                    done = True
                    break
            if done:
                break
        H = Hnew

        colmax = int(vmaxcol.max())
        if colmax > best:
            best = colmax
            if byte_mode and best + bias >= 255:
                overflow = True
                break
            end_ref = i
            Hmax = H.copy()
        if colmax == terminate:
            break

    if not overflow:
        hits = idx[Hmax == best]
        if hits.size:
            cand = int(hits.min())
            if cand < end_read:
                end_read = cand
    return best, end_ref, end_read, overflow


def banded_sw(
    r: np.ndarray, q: np.ndarray, score: int, O: int, E: int, band_width: int, A: int, B: int
) -> Cigar:
    """Literal port of banded_sw (reference ext/ssw/ssw.c:590-770).

    r/q are the clipped ref/read code arrays; returns the M/I/D cigar.
    """
    ref_len = r.shape[0]
    read_len = q.shape[0]
    length = max(ref_len, read_len)
    qv = q.astype(np.int64)
    rv = r.astype(np.int64)

    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width + 1, dtype=np.int64)
        e_b = np.zeros(width + 1, dtype=np.int64)
        h_c = np.zeros(width + 1, dtype=np.int64)
        direction = np.zeros((read_len, width_d, 3), dtype=np.int8)
        mx = 0
        for i in range(read_len):
            beg = max(0, i - band_width)
            end = min(ref_len - 1, i + band_width)
            u_final = 0
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            for j in range(beg, end + 1):
                x = max(0, i - band_width)
                u = j - x + 1
                x1 = max(0, i - 1 - band_width)
                e_idx = j - x1 + 1
                b = j - 1 - x + 1
                d = j - 1 - x1 + 1
                # E (vertical, consumes read -> 'I')
                temp1 = -O if i == 0 else h_b[e_idx] - O
                temp2 = -E if i == 0 else e_b[e_idx] - E
                e_val = max(temp1, temp2)
                de = 3 if temp1 > temp2 else 2
                # F (horizontal, consumes ref -> 'D')
                temp1 = h_c[b] - O
                temp2 = f - E
                f = max(temp1, temp2)
                df = 5 if temp1 > temp2 else 4
                e1 = max(e_val, 0)
                f1 = max(f, 0)
                temp1 = max(e1, f1)
                sub = A if (qv[i] == rv[j] and qv[i] < 4) else -B
                temp2 = h_b[d] + sub
                h_val = max(temp1, temp2)
                if h_val > mx:
                    mx = h_val
                dh = 1 if temp1 <= temp2 else (de if e1 > f1 else df)
                e_b[u] = e_val
                h_c[u] = h_val
                direction[i, j - x, 0] = de
                direction[i, j - x, 1] = df
                direction[i, j - x, 2] = dh
                u_final = u
            h_b[1 : u_final + 1] = h_c[1 : u_final + 1]
        band_width *= 2
        if mx >= score or band_width > length:
            band_width //= 2
            break

    # traceback (reference ext/ssw/ssw.c:676-753)
    i = read_len - 1
    j = ref_len - 1
    e_count = 0
    ops = []  # packed (len<<4|op), to be reversed
    op = prev_op = "M"
    p = 2  # h-layer
    ok = True
    while i >= 0 and j > 0:
        x = max(0, i - band_width)
        d = direction[i, j - x, p]
        if d == 1:
            i -= 1
            j -= 1
            p = 2
            op = "M"
        elif d == 2:
            i -= 1
            p = 0
            op = "I"
        elif d == 3:
            i -= 1
            p = 2
            op = "I"
        elif d == 4:
            j -= 1
            p = 1
            op = "D"
        elif d == 5:
            j -= 1
            p = 2
            op = "D"
        else:
            ok = False
            break
        if op == prev_op:
            e_count += 1
        else:
            ops.append((e_count << 4) | "MIDNSHP=X".index(prev_op))
            prev_op = op
            e_count = 1
    if not ok:
        return Cigar()  # banded_sw failure marker (flag=1 upstream)
    if op == "M":
        ops.append(((e_count + 1) << 4) | CIGAR_MATCH)
    else:
        ops.append((e_count << 4) | "MIDNSHP=X".index(op))
        ops.append((1 << 4) | CIGAR_MATCH)
    ops.reverse()
    return Cigar(ops)


def ssw_align(
    q: np.ndarray, r: np.ndarray, A: int, B: int, O: int, E: int
) -> SswResult:
    """Port of ssw_align with flag=0x0f (begin + cigar always requested):
    byte pass, word rerun on saturation, reverse pass at the winning
    width with terminate=score1, then banded_sw for the cigar."""
    score1, ref_end, read_end, overflow = _striped_pass(
        q, r, A, B, O, E, 16, terminate=255)
    word = False
    if overflow:
        score1, ref_end, read_end, _ = _striped_pass(
            q, r, A, B, O, E, 8, terminate=-1)
        word = True
    if score1 == 0:
        return SswResult(0, -1, -1, 0, 0, 0, Cigar([(1 << 4) | CIGAR_MATCH]))

    # reverse pass on reversed prefixes, stopped at the known score
    q_rev = q[read_end::-1]
    r_rev = r[ref_end::-1]
    score_r, rev_ref_end, rev_read_end, _ = _striped_pass(
        q_rev, r_rev, A, B, O, E, 8 if word else 16, terminate=score1)
    ref_begin = ref_end - rev_ref_end
    read_begin = read_end - rev_read_end
    flag = 0
    if score1 > score_r:
        flag = 2  # alignment path may miss a small part

    ref_len = ref_end - ref_begin + 1
    read_len = read_end - read_begin + 1
    band_width = abs(ref_len - read_len) + 1
    cig = banded_sw(
        r[ref_begin : ref_end + 1], q[read_begin : read_end + 1],
        score1, O, E, band_width, A, B,
    )
    if cig.empty():
        flag = 1
    return SswResult(score1, ref_begin, ref_end, read_begin, read_end, flag, cig)
