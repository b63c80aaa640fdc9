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


def _stream(*groups):
    """Groups of hits as one stream: (hits, seg flags)."""
    hits, seg = [], []
    for g in groups:
        hits += g
        seg += [j == 0 for j in range(len(g))]
    return hits, seg


def _collinear(n):
    """n collinear hits, each extending the one NAM they make."""
    return [(3 * i, 3 * i + 20, 5000 + 3 * i, 5020 + 3 * i) for i in range(n)]


def _opening(r, n, q0=0):
    """n hits within k = 20 of q0 on scattered refs: each opens a NAM."""
    hits = []
    for _ in range(n):
        qs = q0 + r.randrange(0, 15)
        qe = qs + r.randint(15, 40)
        rs = r.randrange(0, 1_000_000)
        hits.append((qs, qe, rs, rs + (qe - qs)))
    return sorted(hits, key=lambda h: (h[0], h[2]))


def _sweeping(r, n, q0=0):
    """n hits that each open a NAM that a sweep a few hits on emits."""
    hits, qs = [], q0
    for _ in range(n):
        qs += r.randint(3, 12)
        qe = qs + r.randint(15, 30)
        rs = r.randrange(0, 1_000_000)
        hits.append((qs, qe, rs, rs + (qe - qs)))
    return hits


def merge_edge_streams(lanes=(8, 32), seed: int = 41):
    """The merge's boundary cases at k = 20 for tables of each size L in
    `lanes` (32: the lane's table in csrc/merge_hits.cu; 8: caps of 8 and
    below overflow on the lane): streams of exactly L and L + 1 hits that
    each open a NAM (the table full, and one more); L + 1 and L + 3 open
    NAMs swept by later hits (at L = 32 a sweep on the warp); hits that
    open a NAM each and close it a few hits on (sweeps that free a lane's
    slots and make it pack them); segment flushes with L and L + 1 NAMs
    open; empty streams among them; then one long chain of collinear hits
    (one NAM, extended) and two streams that hold more than 128 NAMs open
    at once (150, then 140 with a flush of 150 at the segment boundary
    and a sweep). Returns [(hits, seg)]."""
    r = random.Random(seed)

    def opening(n, q0=0):
        return _opening(r, n, q0)

    def sweeping(n, q0=0):
        return _sweeping(r, n, q0)

    out = []
    for L in lanes:
        out += [
            _stream(opening(L)),
            _stream(opening(L + 1)),
            ([], []),
            _stream(opening(L - 1), opening(L)),
            _stream(opening(L + 1) + opening(6, q0=80)),
            _stream(sweeping(3 * L)),
            _stream(opening(L), opening(L + 1), sweeping(2 * L)),
            _stream(opening(L + 3) + opening(4, q0=100), sweeping(L)),
        ]
    return out + [
        _stream(_collinear(40)),
        _stream(opening(1)),
        _stream(opening(150)),
        _stream(opening(150), opening(140) + opening(10, q0=200)),
        ([], []),
    ]


def mixed_merge_streams(n: int = 100, seed: int = 0):
    """n streams of kinds drawn from a seed, so that the merge kernel's
    warps mix streams their lanes finish with streams they hand to the
    whole warp: empty streams, short sweeping ones (1-30 hits), ones that
    open 28-40 NAMs at once (about the lane's 32 slots) and, rarely, 130-150
    (a table in scratch at caps past 128), each kind also followed by a
    second group or a sweep. Returns [(hits, seg)]."""
    r = random.Random(1000 + seed)
    out = []
    for _ in range(n):
        kind = r.choices(["empty", "short", "lane-edge", "wide"], [1, 6, 4, 1])[0]
        if kind == "empty":
            out.append(([], []))
            continue
        first = (_sweeping(r, r.randint(1, 30)) if kind == "short" else
                 _opening(r, r.randint(28, 40) if kind == "lane-edge" else r.randint(130, 150)))
        tail = r.choice([None, "group", "sweep"])
        if tail == "group":
            out.append(_stream(first, _opening(r, r.randint(1, 36))))
        elif tail == "sweep":
            out.append(_stream(first + _sweeping(r, r.randint(1, 20), q0=first[-1][0] + 25)))
        else:
            out.append(_stream(first))
    return out


def lane_chain_streams(n: int = 4096):
    """Two single streams of n hits for a lane's time a hit: collinear
    hits that extend one NAM (a read on its reference), and hits that each
    open a NAM that a sweep a few hits on emits. Returns [(hits, seg)]."""
    r = random.Random(43)
    sweep, qs = [], 0
    for _ in range(n):
        qs += r.randint(8, 14)
        qe = qs + r.randint(15, 25)
        rs = r.randrange(0, 1_000_000)
        sweep.append((qs, qe, rs, rs + (qe - qs)))
    return [_stream(_collinear(n)), _stream(sweep)]


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


def long_runs_world():
    """An index whose repeat array gives runs of about 80 rows (longer
    than a warp's round of 32), and reads on it and off it. Returns
    (index, params, reads)."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References

    from .torch_seed_cases import sampled_reads

    unit = random_dna(300, seed=21)
    genome = random_dna(20000, seed=22) + unit * 80 + random_dna(20000, seed=23)
    refs = References()
    refs.add("c", genome.encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    reads = sampled_reads(genome.encode(), 40, seed=24)
    return index, params, reads


def world_strobes(index, params, reads):
    """The reads' strobes in the seeding buffer's layout, looked up in
    `index`, by the plain versions on the CPU. Returns (the seven
    `strobe_views`, the index planes (hashes, positions, packed))."""
    from rabbitsalign_tpu_torch.ops import seed_device

    from .torch_seed_cases import code_batch

    codes, lens = (torch.from_numpy(a) for a in code_batch(reads))
    sp, rp = params.syncmer, params.randstrobe
    buf, total = seed_device.seed_strobes_plain(codes, lens, sp.k, sp.s, sp.t_syncmer, rp.w_min,
                                                rp.w_max, rp.q, rp.max_dist, 256)
    views = seed_device.strobe_views(buf, len(reads), total)
    h, b = (torch.from_numpy(a.view(np.int64)) for a in (index.hashes,
                                                         index.randstrobe_start_indices))
    views[6].copy_(seed_device.index_find_device(h, b, index.bits, views[2]))
    planes = (h, torch.from_numpy(index.positions.view(np.int32)),
              torch.from_numpy(index.packed.view(np.int32)))
    return views, planes


# the rows of a run that csrc/walk_hits.cu walks on a lane (kLaneRows)
LANE_ROWS = 4
MIXED_RUN_ROWS = (1, 1, 1, 1, 2, 3, LANE_ROWS, LANE_ROWS + 1, 33, 80)


def mixed_runs(n_reads: int = 48, seed: int = 31):
    """The run walk's inputs on a synthetic index whose runs have 1, 2,
    3, LANE_ROWS, LANE_ROWS + 1, 33 and 80 rows, and reads of 0 to 70
    strobes (over two rounds of 32) that hit them in random order, so
    that a round mixes runs a lane finishes alone with runs the warp
    finishes; one in eight reads a tie row (count -1), one strobe in
    eight a miss. The reference spans come from a few lengths, so that
    the keep rule keeps and drops rows of one run in every pattern, and
    some reference starts have the top bit set. Returns (counts, offsets,
    hashes, starts, ends, is_rev, positions, idx_hashes, idx_pos,
    idx_packed) as `walk_hits` takes them, and the run length of every
    strobe (0 for a miss)."""
    rng = np.random.RandomState(seed)
    lens = np.array([MIXED_RUN_ROWS[i % len(MIXED_RUN_ROWS)] for i in range(120)])
    keys = np.unique(rng.randint(1, 2 ** 62, 200, dtype=np.int64))[:len(lens)]
    keys = np.sort(keys.astype(np.uint64) * np.uint64(3))  # some with the top bit set
    run_at = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n = int(lens.sum())
    idx_hashes = np.repeat(keys, lens)
    idx_pos = rng.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    spans = np.array([12, 15, 16, 18, 21], dtype=np.uint32)
    idx_packed = (rng.randint(0, 5000, n).astype(np.uint32) << 8) | rng.choice(spans, n)
    counts = rng.randint(0, 71, n_reads).astype(np.int32)
    counts[rng.rand(n_reads) < 0.125] = -1
    T = int(np.maximum(counts, 0).sum())
    offsets = np.concatenate([[0], np.cumsum(np.maximum(counts, 0))[:-1]]).astype(np.int64)
    run = rng.randint(0, len(lens), T)
    miss = rng.rand(T) < 0.125
    positions = np.where(miss, -1, run_at[run]).astype(np.int64)
    hashes = np.where(miss, rng.randint(1, 2 ** 62, T).astype(np.uint64), keys[run])
    starts = rng.randint(0, 120, T).astype(np.int32)
    ends = starts + rng.randint(30, 40, T).astype(np.int32)
    is_rev = rng.randint(0, 2, T).astype(np.uint8)
    arrays = (counts, offsets, hashes.view(np.int64), starts, ends, is_rev, positions,
              idx_hashes.view(np.int64), idx_pos.view(np.int32), idx_packed.view(np.int32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), \
        np.where(miss, 0, lens[run])
