"""Synthetic extend batches and mapping inputs shared by the port's tests
and chip_smoke.py: numpy only (no jax, no torch), so they also run where
JAX is absent."""

import random

import numpy as np

KINDS = ("planted", "indel", "n-run", "tandem", "junk", "empty", "overflow")


def q2_batch(pairs, Q, seed=0):
    """(q2 upload (rows, B) u8, genome codes): each pair's target is laid
    into a random genome and its query packed 2-bit with the N mask, as
    engine.cpp chunk_fill_batch_q2 does. Pairs are (query, target) code
    arrays (0..4)."""
    rng = np.random.RandomState(seed)
    Qp, Qm = (Q + 3) // 4, (Q + 7) // 8
    B = len(pairs)
    buf = np.zeros((Qp + Qm + 8, B), dtype=np.uint8)
    parts = [rng.randint(0, 4, 64).astype(np.uint8)]
    off = 64
    for b, (q, t) in enumerate(pairs):
        q = np.asarray(q, dtype=np.uint8)
        t = np.asarray(t, dtype=np.uint8)
        r = np.arange(q.shape[0])
        np.bitwise_or.at(buf[:, b], r >> 2, ((q & 3) << ((r & 3) << 1)).astype(np.uint8))
        np.bitwise_or.at(buf[:, b], Qp + (r >> 3),
                         np.where(q >= 4, 1 << (r & 7), 0).astype(np.uint8))
        tail = buf[Qp + Qm:, b]
        tail[0:2] = (q.shape[0] & 0xFF, q.shape[0] >> 8)
        tail[2:4] = (t.shape[0] & 0xFF, t.shape[0] >> 8)
        tail[4:8] = [(off >> s) & 0xFF for s in (0, 8, 16, 24)]
        parts += [t, rng.randint(0, 4, 16).astype(np.uint8)]
        off += t.shape[0] + 16
    return buf, np.concatenate(parts)


def q2_edge_batch(Q, T, B, seed=0):
    """(q2 upload, genome codes) of B >= 8 mixed pairs (`q2_batch`) with
    the edge columns that a reader of the q2 layout must take as
    `unpack_q2` does: qlen 0 (column 1), tlen 0 (2), both at the bucket's
    maximum (3) and past it (4), these two with random codes in every code
    row and column 4 with an N in its last row, and target windows at the
    genome's end: starting T // 2 before it (5), at its last code (6) and
    at the largest u32 offset (7). With the genome itself as the flat
    array, the clamp min(tstart + t, len - 1) repeats its last code there;
    `resident_ref_codes`' copy reads its padding of code 4."""
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=seed), Q, seed=seed)
    rng = np.random.RandomState(seed)
    Qp, Qm = (Q + 3) // 4, (Q + 7) // 8
    buf[:Qp, 3:5] = rng.randint(0, 256, (Qp, 2))
    buf[Qp + (Q - 1) // 8, 4] |= 1 << ((Q - 1) % 8)
    tail = buf[Qp + Qm:]
    n = genome.shape[0]
    edges = {1: (0, None, None), 2: (None, 0, None), 3: (Q, T, None), 4: (Q + 9, T + 2, None),
             5: (None, T, n - T // 2), 6: (None, T, n - 1), 7: (None, T, 2**32 - 1)}
    for col, (qlen, tlen, tstart) in edges.items():
        for row, value, width in ((0, qlen, 2), (2, tlen, 2), (4, tstart, 4)):
            if value is not None:
                tail[row:row + width, col] = [(value >> (8 * i)) & 0xFF for i in range(width)]
    return buf, genome


def bucket_arrays(pairs, Q, T):
    """(q_t (Q, B), t_t (T, B) u8 padded with code 4, qlen, tlen (B,) i32)
    of (query, target) code pairs: a BatchAligner bucket's arrays, which
    extend_device.pack_input packs."""
    B = len(pairs)
    q_t = np.full((Q, B), 4, np.uint8)
    t_t = np.full((T, B), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(pairs):
        q_t[: q.shape[0], b], t_t[: t.shape[0], b] = q, t
        qlen[b], tlen[b] = q.shape[0], t.shape[0]
    return q_t, t_t, qlen, tlen


def mixed_pairs(Q, T, B, seed=0):
    """B (query, target) code pairs cycling through KINDS, sized to the
    (Q, T) bucket: a planted query with SNPs, one with indels, one with an
    N run, tandem repeats (dense score ties), unrelated junk with N codes,
    an empty query, and a query with a mismatch every sixth base whose
    alignment has more than 32 cigar runs."""
    rng = np.random.RandomState(seed)
    pairs = []
    for b in range(B):
        kind = KINDS[b % len(KINDS)]
        m = int(rng.randint(max(1, Q // 2), Q + 1))
        n = int(rng.randint(min(m, T), T + 1))
        t = rng.randint(0, 4, n).astype(np.uint8)
        if kind in ("planted", "indel", "n-run", "overflow"):
            st = int(rng.randint(0, n - min(m, n) + 1))
            q = t[st:st + m].copy()
            if kind == "planted":
                q[rng.randint(0, q.shape[0], 3)] = rng.randint(0, 4, 3)
            elif kind == "indel":
                cut = int(rng.randint(1, max(2, q.shape[0] - 1)))
                if rng.randint(2):
                    q = np.concatenate([q[:cut], q[cut + int(rng.randint(1, 6)):]])
                else:
                    q = np.concatenate([q[:cut], rng.randint(0, 4, int(rng.randint(1, 5))),
                                        q[cut:]])[:Q].astype(np.uint8)
            elif kind == "n-run":
                p = int(rng.randint(0, max(1, q.shape[0] - 8)))
                q[p:p + int(rng.randint(2, 8))] = 4
            else:
                q[3::6] = (q[3::6] + 1) % 4
        elif kind == "tandem":
            u = int(rng.randint(3, 20))
            q = (np.arange(m) % u % 4).astype(np.uint8)
            t = (np.arange(n) % u % 4).astype(np.uint8)
        elif kind == "junk":
            q = rng.randint(0, 5, m).astype(np.uint8)
            t = rng.randint(0, 5, n).astype(np.uint8)
        else:  # empty
            q = np.zeros(0, np.uint8)
        pairs.append((q[:Q], t[:T]))
    return pairs


def gap_pairs(Q, T, seed):
    """Pairs whose walks leave tiles sideways (long insertion and deletion
    runs), walk off at q = 0 (the query's first base aligned) and at t = 0
    (the target's first base aligned after a query prefix), end at the
    (Q-1, T-1) corner, have more than 32 cigar runs from Q ~ 110 on (a
    mismatch every sixth base), or score 0 (an all-N query)."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 4, T).astype(np.uint8)
    m = min(Q, T) // 3
    ins = np.concatenate([t[5:5 + m], rng.randint(0, 4, m // 2), t[5 + m:5 + 2 * m]])
    dele = np.concatenate([t[3:3 + m], t[3 + m + m // 2:3 + 2 * m + m // 2]])
    off_t = np.concatenate([rng.randint(0, 4, 4), t[:Q - 4]])
    over = t[T - Q:].copy()
    over[3::6] = (over[3::6] + 1) % 4
    pairs = [(ins[:Q].astype(np.uint8), t), (dele[:Q], t), (t[7:7 + Q], t), (off_t, t),
             (t[T - Q:], t), (over, t), (np.full(Q, 4, np.uint8), t)]
    return [(q.astype(np.uint8), tt) for q, tt in pairs]


READ_LEN = 150
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def sim_read(genome: bytes, st: int, rng) -> bytes:
    """A read at `st` with 0-2 SNPs, and in two of three reads an indel
    (1-5 bp), so phase A leaves many gapped-extension jobs."""
    kind = rng.randint(3)
    if kind == 1:  # deletion
        cut, g = rng.randint(40, 100), rng.randint(1, 6)
        rd = genome[st:st + cut] + genome[st + cut + g:st + READ_LEN + g]
    elif kind == 2:  # insertion
        cut, g = rng.randint(40, 100), rng.randint(1, 5)
        ins = rng.choice(np.frombuffer(b"ACGT", np.uint8), g).tobytes()
        rd = genome[st:st + cut] + ins + genome[st + cut:st + READ_LEN - g]
    else:
        rd = genome[st:st + READ_LEN]
    rd = bytearray(rd)
    for _ in range(rng.randint(3)):
        rd[rng.randint(READ_LEN)] = b"ACGT"[rng.randint(4)]
    return bytes(rd)


def write_fastq(path, reads, prefix):
    with open(path, "wb") as f:
        for i, rd in enumerate(reads):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, rd, b"I" * len(rd)))


def batch_jobs(genome: str, seed: int = 3):
    """(query, ref) BatchAligner jobs as phase A makes them, on a genome
    string: reads with SNPs and indels against their window +- 50 bp,
    reverse complements, unrelated reads, targets for the second and
    third bucket, one that fits no small bucket of
    tests/test_torch_align.py (aligned on the host) and one past 2000
    (refused, like Aligner.align); then a zero-score pair, a pair of more than RLE_M
    cigar runs (redone on the host), a tiny and an empty query, and two
    reads with three mismatches in four bases (at -O 1 -E 1 an I and a D
    cost less than an X, and paths of equal score abound)."""
    rng = random.Random(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    jobs = []
    for i in range(18):
        st = rng.randrange(100, len(genome) - 2200)
        qlen = 200 if i % 8 == 5 else rng.choice((100, 150))
        read = bytearray(genome[st:st + qlen].encode())
        for _ in range(rng.randrange(0, 4)):
            read[rng.randrange(qlen)] = ord(rng.choice("ACGT"))
        if i % 4 == 1:
            cut = rng.randrange(20, qlen - 20)
            read = read[:cut] + read[cut + rng.randrange(1, 6):]
        if i % 6 == 2:
            cut = rng.randrange(20, qlen - 20)
            read = read[:cut] + bytes(rng.choice(b"ACGT") for _ in range(3)) + read[cut:]
        pad = {0: 50, 1: 150, 2: 400, 3: 50}[i % 4]
        pad = {11: 1000, 17: 2000}.get(i, pad)  # no bucket; past 2000
        ref = genome[st - 50:st + qlen + pad].encode()
        if i % 5 == 3:
            read, ref = bytes(read).translate(comp)[::-1], ref.translate(comp)[::-1]
        if i % 10 == 9:
            read = bytearray(rng.choice(b"ACGT") for _ in range(qlen))
        jobs.append((bytes(read), ref))
    over = bytearray(genome[500:650].encode())
    over[3::6] = bytes(ord("A") if c != ord("A") else ord("C") for c in over[3::6])
    jobs += [(b"A" * 40, b"C" * 80), (bytes(over), genome[450:700].encode()),
             (b"ACGT" * 3, b"ACGT" * 3), (b"", genome[0:40].encode())]
    for st in (1000, 2994):
        read = bytearray(genome[st:st + 120].encode())
        for p in (st % 50 + 30, st % 50 + 32, st % 50 + 33):
            read[p] = b"CGTA"[b"ACGT".index(read[p])]
        jobs.append((bytes(read), genome[st - 50:st + 170].encode()))
    return jobs


def write_pe250(d, seed: int, n_pairs: int = 300, genome_bp: int = 300_000,
                deletion_every: int = 2, random_every: int = 25):
    """`ref.fa`, `r1.fq` and `r2.fq` in `d`: 2x250 Illumina-like pairs on a
    random genome, insert N(550, 100) clipped to [300, 1000], 0-5
    substitutions a mate, a 1-5 bp deletion at read offset 40-200 in mate 1
    of every `deletion_every`-th pair (gapped extends of 250-base queries),
    and a random mate 2 in every `random_every`-th pair. Returns, for each
    pair, whether its mate 2 is random."""
    rng = np.random.RandomState(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), genome_bp).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1\n" + genome + b"\n")
    L = 250

    def mate(st: int, deletion: int) -> bytes:
        cut = int(rng.randint(40, 201))
        rd = bytearray(genome[st:st + cut] + genome[st + cut + deletion:st + L + deletion])
        for p in rng.choice(L, int(rng.randint(0, 6)), replace=False):
            rd[p] = b"ACGT"[(b"ACGT".index(rd[p]) + int(rng.randint(1, 4))) % 4]
        return bytes(rd)

    r1, r2, random_mate = [], [], []
    for i in range(n_pairs):
        insert = int(np.clip(rng.normal(550, 100), 300, 1000))
        st = int(rng.randint(genome_bp - 1010))
        r1.append(mate(st, int(rng.randint(1, 6)) if i % deletion_every == 0 else 0))
        random_mate.append(i % random_every == random_every - 1)
        r2.append(rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes() if random_mate[-1]
                  else revcomp(mate(st + insert - L, 0)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")
    return random_mate
