"""Read batches for the seeding kernels (ops/seed_cuda.py) in the GPU
tests and chip_smoke.py: numpy only, seeded, no jax."""

import numpy as np

SEED_L = 256  # the device's longest read (pipeline/native_pipeline.py SEED_L)

NT4 = np.full(256, 4, dtype=np.uint8)
for _ch, _code in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    NT4[_ch] = _code


def edge_reads(seed: int = 0):
    """Reads of length 0, 11 (< w_max), 150, 256 and 300 (longer than
    SEED_L: length -1 in the batch), all-N, N runs, and tandem repeats
    whose k-mer windows hold duplicated minima (tie rows)."""
    rng = np.random.RandomState(seed)

    def dna(n):
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()

    reads = [b"", dna(11), dna(150), dna(SEED_L), dna(300), b"N" * 150, b"N" * SEED_L]
    for run in (1, 4, 30):
        r = bytearray(dna(150))
        r[60:60 + run] = b"N" * run
        reads.append(bytes(r))
    reads.append(b"N" * 20 + dna(130))
    for unit in (1, 2, 3, 8, 25):
        reads.append((dna(unit) * (SEED_L // unit + 1))[:150])
    return reads


def code_batch(reads, L: int = SEED_L):
    """(codes (B, L) u8 with 4 past each read's end, lengths (B,) i32 with
    -1 for a read longer than L), as NativeEngine.fx_codes exports them."""
    codes = np.full((len(reads), L), 4, dtype=np.uint8)
    lens = np.empty(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        if len(r) > L:
            lens[i] = -1
            continue
        codes[i, :len(r)] = NT4[np.frombuffer(r, dtype=np.uint8)]
        lens[i] = len(r)
    return codes, lens


def sampled_reads(genome: bytes, n: int, seed: int, length: int = 150):
    """n reads of `length` from `genome`, one base in 200 changed, every
    third one reverse-complemented."""
    rng = np.random.RandomState(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i in range(n):
        st = rng.randint(len(genome) - length)
        r = bytearray(genome[st:st + length])
        for p in np.flatnonzero(rng.rand(length) < 0.005):
            r[p] = b"ACGT"[(b"ACGT".index(r[p]) + 1) % 4] if r[p] in b"ACGT" else r[p]
        r = bytes(r)
        out.append(r.translate(comp)[::-1] if i % 3 == 1 else r)
    return out


def tie_reads(n: int, seed: int, length: int = 150):
    """n reads whose k-mer windows hold tied minima, for the exact
    syncmer scan: tandem repeats of 1-29 bp units (homopolymers and 2-5 bp
    repeats among them) over the whole read, set between random flanks,
    starting right after an N run, or cut by one, in turn."""
    rng = np.random.RandomState(seed)

    def dna(m):
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), m).tobytes()

    out = []
    for i in range(n):
        unit = dna(int(rng.randint(1, 6) if i % 2 else rng.randint(1, 30)))
        rep = unit * (2 * length // len(unit) + 2)
        kind = i % 4
        if kind == 0:
            read = rep[:length]
        elif kind == 1:
            a, b = rng.randint(0, 60), rng.randint(20, 100)
            read = dna(a) + rep[:b] + dna(length)
        elif kind == 2:
            read = dna(rng.randint(0, 50)) + b"N" * rng.randint(1, 5) + rep
        else:
            a = rng.randint(30, 110)
            read = rep[:a] + b"N" * rng.randint(1, 4) + rep[a:]
        out.append(read[:length])
    return out


def long_scan_reads(seed: int = 11):
    """Reads of up to 1500 bases for a batch of L = 1600 (three of the
    exact scan's 512-window segments): homopolymers and short tandem
    repeats across the segments' boundaries, a read past L (-1), random
    sequence with an N run, and a read whose first segment ends on 16
    windows of w = 32 that all tie off offset t - 1 at k 32, s 1, t 16
    (the A/T s-mers hash below the C/G ones there: windows 496-511 hold
    two A/T or more, none at offset 15)."""
    rng = np.random.RandomState(seed)

    def dna(n):
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()

    reads = [b"A" * 1500, (b"AC" * 800)[:1500], (b"GAT" * 600)[:1500],
             dna(480) + b"T" * 120 + dna(400) + b"CA" * 100 + dna(300), dna(1700),
             dna(700) + b"N" * 3 + dna(500), dna(1500)]
    reads += [dna(int(rng.randint(400, 560))) + (dna(int(u)) * 200)[:300] + dna(600)
              for u in (1, 2, 3, 4, 5)]
    reads.append(dna(496) + b"A" * 15 + b"C" * 16 + b"TA" + dna(571))
    return reads
