"""Inputs for the device NAM front end's tests (ops/chain_device.py,
ops/front_device.py and their kernels): numpy and the standard library
only, seeded, no jax, so that the GPU tests and the host emulation can
use them too."""

import random

import numpy as np
import torch

from .util import random_dna


def synthetic_streams(n: int = 30, seed: int = 99):
    """tests/test_chain_device.py:38's raw hit streams: 1 to 3 groups of
    1 to 40 hits each, sorted by (query start, ref start), overlapping
    windows and equal starts included. Returns [(hits [(qs, qe, rs, re)],
    seg flags)]."""
    r = random.Random(seed)
    out = []
    for _ in range(n):
        stream, seg = [], []
        for _ in range(r.randint(1, 3)):
            hits = []
            for _ in range(r.randint(1, 40)):
                qs = r.randrange(0, 130)
                qe = qs + r.randint(15, 40)
                rs = r.randrange(0, 400)
                hits.append((qs, qe, rs, rs + (qe - qs) + r.randint(-3, 3)))
            hits.sort(key=lambda h: (h[0], h[2]))
            stream += hits
            seg += [j == 0 for j in range(len(hits))]
        out.append((stream, seg))
    return out


def wide_streams(n: int = 6, seed: int = 5):
    """Streams that hold more than 32 NAMs open at once (so the merge
    kernel's second to fourth slot groups fill, empty and compact): a
    group of 40 to 110 hits whose query starts stay within k = 20 of the
    first, on scattered ref starts (every hit opens a NAM), then hits
    further on that flush some of them, then a second group."""
    r = random.Random(seed)
    out = []
    for _ in range(n):
        stream, seg = [], []
        for g in range(2):
            hits = []
            for _ in range(r.randint(40, 110)):
                qs = r.randrange(0, 20)
                qe = qs + r.randint(15, 60)
                rs = r.randrange(0, 100_000)
                hits.append((qs, qe, rs, rs + (qe - qs) + r.randint(-2, 2)))
            for _ in range(r.randint(5, 30)):
                qs = r.randrange(25, 90)
                qe = qs + r.randint(15, 40)
                rs = r.randrange(0, 100_000)
                hits.append((qs, qe, rs, rs + (qe - qs)))
            hits.sort(key=lambda h: (h[0], h[2]))
            stream += hits
            seg += [j == 0 for j in range(len(hits))]
        out.append((stream, seg))
    return out


def stream_tensors(streams):
    """Streams as the merge's (hits (N, 4) int32, seg (N,) bool, offsets
    (S + 1,) int64) CPU tensors."""
    sizes = [len(h) for h, _ in streams]
    hits = torch.tensor([x for h, _ in streams for x in h], dtype=torch.int32).reshape(-1, 4)
    seg = torch.tensor([f for _, s in streams for f in s], dtype=torch.bool)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64)
    return hits, seg, offsets


def world_genome():
    """tests/test_chain_device.py:24-35's genome: 81 kbp, a 400 bp unit
    repeated 30 times, and a 9 kbp segment shared by its two contigs (cA
    the first 45 kbp, cB the rest)."""
    unit = random_dna(400, seed=51)
    return (random_dna(30000, seed=50) + unit * 30 + random_dna(30000, seed=52)
            + random_dna(20000, seed=50)[:9000])


def chain_reads(genome: str):
    """tests/test_chain_device.py:119's 50 reads: random starts, the
    repeat array, and the segment the two contigs share."""
    r = random.Random(7)
    reads = []
    for i in range(50):
        if i % 3 == 1:
            st = 30000 + r.randrange(0, 400 * 28)
        elif i % 3 == 2:
            st = 45000 + 9000 - 150 - r.randrange(0, 8000)
        else:
            st = r.randrange(0, len(genome) - 200)
        reads.append(genome[st:st + 150].encode())
    return reads


def composed_reads(genome: str):
    """tests/test_chain_device.py:143's 60 reads: one base changed, every
    third reverse-complemented, every tenth on the repeat array, and
    random junk."""
    r = random.Random(8)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    seqs = []
    for i in range(60):
        if i % 11 == 5:
            sq = "".join(r.choice("ACGT") for _ in range(150))
        else:
            st = (r.randrange(30000, 30000 + 400 * 30) if i % 10 == 0
                  else r.randrange(0, len(genome) - 200))
            s = list(genome[st:st + 150])
            s[r.randrange(150)] = r.choice("ACGT")
            sq = "".join(s)
            if i % 3 == 1:
                sq = "".join(comp[c] for c in reversed(sq))
        seqs.append(sq.encode())
    return seqs


def nam_key(n, score=float):
    """The NAM fields the device merge carries (the prev-hit starts are
    the host merge's scratch, which neither package's device path
    returns), the score as `score` makes it (np.float32 against the
    engine's float32 scores)."""
    return (n.nam_id, n.query_start, n.query_end, n.ref_start, n.ref_end, n.ref_id, n.n_hits,
            score(n.score), n.is_rc)
