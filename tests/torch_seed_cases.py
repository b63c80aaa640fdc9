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
