"""The sources of the device NAM front end's kernels, run on the CPU by
the thread-a-lane emulation of tests/torch_cuda_emu.h, against their
plain PyTorch versions: the exact syncmer scan (csrc/syncmers_scan.cu),
the sweep-line merge (csrc/merge_hits.cu) on its lane and warp paths,
at caps past 128 and with tables that overflow, and the run walk with its
keep rule (csrc/walk_hits.cu) on runs longer than a warp, with hits that
overflow. Everything is integer and made from a seed: every comparison is
exact."""

import numpy as np
import pytest
import torch

from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.ops import cuda_build, seed_device
from rabbitsalign_tpu_torch.ops.chain_device import merge_hits_plain
from rabbitsalign_tpu_torch.ops.front_device import (walk_hits_compact_plain, walk_hits_plain,
                                                     walk_views, walk_words)
from rabbitsalign_tpu_torch.seed.hash import xxh64
from rabbitsalign_tpu_torch.seed.syncmers import _packed_mers

from . import torch_chain_cases, torch_cuda_emu
from .torch_chain_cases import (LANE_ROWS, merge_edge_streams, mixed_merge_streams, mixed_runs,
                                stream_tensors, synthetic_streams, wide_streams, world_strobes)
from .torch_seed_cases import code_batch, edge_reads, long_scan_reads, sampled_reads, tie_reads
from .util import random_dna


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions at these sizes run as fast on one thread as on
    eight; torch's intra-op threads would only crowd the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain_emu(tmp_path_factory):
    """The three sources built for the host, each its own library."""
    out = tmp_path_factory.mktemp("chain_emu")
    libs = {}
    for name, entry in (("syncmers_scan", "syncmers_scan_launch"),
                        ("merge_hits", "merge_hits_launch"), ("walk_hits", "walk_hits_launch")):
        libs[name] = torch_cuda_emu.build(name, out)
        cuda_build.declare(libs[name], (entry,))
    return libs


def _scan_reads():
    """Edge reads (empty, short, N runs, all-N, tandem repeats with
    duplicated window minima), sampled reads and more tandem repeats."""
    genome = random_dna(20000, seed=3).encode()
    rng = np.random.RandomState(4)
    repeats = [(random_dna(int(u), seed=int(u)) * 80)[:150].encode()
               for u in rng.randint(1, 30, 24)]
    return edge_reads(2) + sampled_reads(genome, 60, seed=5) + repeats


@pytest.mark.parametrize("M", [256, 12], ids=["M256", "M12"])
def test_syncmers_scan_source_on_host_matches_plain(chain_emu, M):
    """Positions, hashes and counts equal `syncmers_scan_plain`, for
    rows with tied minima, N runs, lengths 0 and past L (-1), and at
    M = 12 where rows have more syncmers than slots."""
    codes, lens = (torch.from_numpy(a) for a in code_batch(_scan_reads()))
    p = IndexParameters.from_read_length(150).syncmer
    want = seed_device.syncmers_scan_plain(codes, lens, p.k, p.s, p.t_syncmer, M)
    got = _emu_scan(chain_emu["syncmers_scan"], codes, lens, p.k, p.s, p.t_syncmer, M)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2].max()) == M if M == 12 else int(want[2].sum()) > 1000


# csrc/syncmers_scan.cu: windows a lane a segment (kLaneWin), a segment (kSeg)
LANE_WIN = 16
SEG = 32 * LANE_WIN
SCAN_CONFIGS = [(20, 16, 3), (15, 9, 4), (24, 12, 7), (32, 1, 16), (9, 9, 1)]


def _scan_schedule(codes, length, k, s, t):
    """A model of the replays csrc/syncmers_scan.cu makes on one read
    (codes (L,) u8, its length): its segments, its lanes' runs of windows
    and the state each lane carries. Returns (replays, tied_starts): for
    each replay (its window, the lane's first window, the segment's first
    window, the window it starts from (base - 1: the carried state), True
    when it only passes a segment's last state on), and the count of
    windows that start their N-free run after an N with a tied minimum."""
    end = min(length, codes.shape[0]) if length >= 0 else -1
    nk = end - k + 1
    if nk <= 0:
        return [], 0
    c = codes[:end]
    smer, s_ok = _packed_mers(c, s)  # the s-mer ending at each position
    h = np.where(s_ok[s - 1:], xxh64(smer[s - 1:]), np.uint64(2 ** 64 - 1))
    clean = _packed_mers(c, k)[1][k - 1:]
    start = clean & np.r_[True, c[:nk - 1] >= 4]
    w = k - s + 1

    def tied(pos):
        v = h[pos:pos + w]
        return int((v == v.min()).sum()) > 1

    def replay(pos, base):
        q = pos - 1
        while q >= base and not start[q] and tied(q):
            q -= 1
        return q

    replays, tied_starts = [], 0
    for base in range(0, nk, SEG):
        seg_end = min(base + SEG, nk)
        per = -(-(seg_end - base) // 32)
        for p0 in range(base, seg_end, per):
            known = p0 == base and base > 0
            for pos in range(p0, min(p0 + per, seg_end)):
                if not clean[pos]:
                    known = False
                    continue
                tied_starts += bool(start[pos] and pos > 0 and tied(pos))
                if start[pos] or not tied(pos) or known:
                    known = True
                elif h[pos + t - 1] == h[pos:pos + w].min():
                    replays.append((pos, p0, base, replay(pos, base), False))
                    known = True
        if seg_end < nk and not known and clean[seg_end - 1]:
            replays.append((seg_end - 1, p0, base, replay(seg_end - 1, base), True))
    return replays, tied_starts


def _emu_scan(lib, codes, lens, k, s, t, M):
    B = codes.shape[0]
    got = (torch.full((B, M), 7, dtype=torch.int32), torch.full((B, M), 7, dtype=torch.int64),
           torch.full((B,), 7, dtype=torch.int32))
    assert lib.syncmers_scan_launch(codes.data_ptr(), lens.data_ptr(), B, codes.shape[1], k, s,
                                    t, M, *(x.data_ptr() for x in got), None) == 0
    return got


def _schedule_counts(codes, lens, k, s, t):
    """Over a batch: replays at a lane's first window, replays that start
    in an earlier lane's range, replays from the carried state of the
    segment before, whole-run replays (100 windows or more), tied run
    starts after an N, and replays that pass a segment's state on."""
    out = np.zeros(6, dtype=np.int64)
    for row, n in zip(codes.numpy(), lens.numpy()):
        replays, tied_starts = _scan_schedule(row, int(n), k, s, t)
        for pos, p0, base, q, seg_end in replays:
            out += [pos == p0, q < p0, q < base, pos - q >= 100, 0, seg_end]
        out[4] += tied_starts
    return out


@pytest.mark.parametrize("k,s,t", SCAN_CONFIGS, ids=[f"k{k}s{s}t{t}" for k, s, t in SCAN_CONFIGS])
def test_syncmers_scan_source_on_tie_reads(chain_emu, k, s, t):
    """On tie-heavy reads (tandem repeats of 1-29 bp units, homopolymers,
    2-5 bp repeats, N runs before and inside them) and the edge reads,
    positions, hashes and counts equal `syncmers_scan_plain` at the
    default (k, s, t) and four others, w = 32 (the launcher's limit) and
    w = 1 among them. Where w > 1 the kernel's schedule (its lane model,
    `_scan_schedule`) meets every case of the replay: a tied window at a
    lane's first window, a replay that starts in an earlier lane's range,
    a replay over 100 windows of one run, and a tied window that starts
    its run right after an N."""
    codes, lens = (torch.from_numpy(a) for a in code_batch(tie_reads(96, seed=k) +
                                                            edge_reads(k)))
    want = seed_device.syncmers_scan_plain(codes, lens, k, s, t, 256)
    got = _emu_scan(chain_emu["syncmers_scan"], codes, lens, k, s, t, 256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2].sum()) > 300
    if k - s + 1 > 1:
        at_lane_start, from_earlier_lane, _, whole_run, tied_starts, _ = _schedule_counts(
            codes, lens, k, s, t)
        assert at_lane_start > 0 and from_earlier_lane > 0 and whole_run > 0
        assert tied_starts > 0


@pytest.mark.parametrize("k,s,t,M", [(20, 16, 3, 1600), (20, 16, 3, 64), (32, 1, 16, 1600)],
                         ids=["M1600", "M64", "k32s1t16"])
def test_syncmers_scan_source_on_long_reads(chain_emu, k, s, t, M):
    """Reads of up to 1500 bases (three segments of the kernel) at L =
    1600: homopolymers and short tandem repeats across the segments'
    boundaries, a read past L (-1), random sequence with N runs, and a
    read whose first segment ends on a lane of w = 32 windows that all
    tie off offset t - 1. Equal to `syncmers_scan_plain`, with M = 64
    where rows have more syncmers than slots; the schedule replays from
    the state carried over a segment's start, and at w = 32 replays a
    segment's last window only to pass its state on."""
    reads = long_scan_reads()
    codes, lens = (torch.from_numpy(a) for a in code_batch(reads, L=1600))
    want = seed_device.syncmers_scan_plain(codes, lens, k, s, t, M)
    got = _emu_scan(chain_emu["syncmers_scan"], codes, lens, k, s, t, M)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2][4]) == 0 and (int(want[2].max()) == M if M == 64 else
                                     int(want[2].max()) > 40)
    counts = _schedule_counts(codes, lens, k, s, t)
    assert counts[2] > 0 and (counts[5] > 0 or k != 32)


def _emu_merge(lib, hits, seg, offsets, k, cap):
    """The merge source on the host, its outputs filled with 0x7F7F7F7F
    bytes first so that an element it does not write shows."""
    S, N = offsets.numel() - 1, hits.shape[0]
    out = torch.full((N, 7), 0x7F7F7F7F, dtype=torch.int32)
    counts = torch.full((S,), 0x7F7F7F7F, dtype=torch.int32)
    ovf = torch.full((S,), 0x7F, dtype=torch.uint8)
    scratch = torch.full((N, 7), 0x7F7F7F7F, dtype=torch.int32) if cap > 128 else None
    assert lib.merge_hits_launch(hits.data_ptr(), seg.data_ptr(), offsets.data_ptr(), S, N, k,
                                 cap, out.data_ptr(), counts.data_ptr(), ovf.data_ptr(),
                                 None if scratch is None else scratch.data_ptr(), None) == 0
    assert bool((ovf <= 1).all())
    return out, counts, ovf.bool()


def _merge_streams(which):
    """The named streams of tests/torch_chain_cases.py; "mixedN" is
    `mixed_merge_streams` at seed N."""
    if which.startswith("mixed"):
        return mixed_merge_streams(seed=int(which[5:]))
    return {"synthetic": synthetic_streams, "wide": wide_streams,
            "edge": merge_edge_streams}[which]()


@pytest.mark.parametrize("which,cap,overflows", [
    ("synthetic", 32, False), ("synthetic", 4, True), ("synthetic", 1, True),
    ("wide", 128, False), ("wide", 72, True), ("wide", 200, False), ("wide", 33, True),
    ("wide", 64, True), ("wide", 65, True),
    ("edge", 200, False), ("edge", 129, True), ("edge", 128, True), ("edge", 65, True),
    ("edge", 64, True), ("edge", 33, True), ("edge", 32, True), ("edge", 8, True),
    ("edge", 3, True), ("edge", 1, True),
    ("mixed0", 32, True), ("mixed1", 33, True), ("mixed2", 48, True), ("mixed3", 100, True),
    ("mixed4", 140, True), ("mixed5", 200, False)])
def test_merge_source_on_host_matches_plain(chain_emu, which, cap, overflows):
    """The emission rows (zeros past each count), counts and overflow
    flags equal `merge_hits_plain`: the synthetic streams of
    test_chain_device.py at the callers' cap 32 and at 4 and 1
    (overflowing on the lane), streams holding over 32 NAMs open at caps
    that hold them, that overflow and past 128, and the boundary cases of
    `merge_edge_streams` (the lane's table of 32 slots full and one past
    it, sweeps and segment flushes on the lane and on the warp, empty
    streams, more than 128 NAMs open). Caps 33, 64, 65, 128 and 129 put
    the warp's stream at the edges of its 2 and 4 slot groups and of its
    table in scratch; 32 and below overflow on the lane. The mixed streams
    (empty, short, about 32 and over 128 NAMs open, in an order drawn from
    a seed) make warps whose lanes finish some streams and hand others to
    the whole warp."""
    streams = _merge_streams(which)
    args = stream_tensors(streams)
    want = merge_hits_plain(*args, 20, cap)
    got = _emu_merge(chain_emu["merge_hits"], *args, 20, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[2].any()) == overflows
    if (which, cap) != ("wide", 33):  # there every stream overflows before it emits
        assert int(want[1].sum()) > (len(streams) if cap > 3 else 0)
    if which == "wide":  # a flush of more than 64 open NAMs: all four slot groups
        assert int(want[0][:, 0].bincount().max()) > 64 or cap < 128
    if which.startswith("mixed"):
        H = args[2][1:] - args[2][:-1]
        assert bool((H == 0).any()) and bool((H > 128).any())


def test_merge_source_zeroes_rows_outside_the_streams(chain_emu):
    """Rows before the first stream and after the last (offsets that do
    not cover the hits), and a call with no stream, come back zero."""
    hits, seg, offsets = stream_tensors(merge_edge_streams()[:2])
    pad = torch.zeros((3, 4), dtype=torch.int32)
    hits = torch.cat([pad, hits, pad])
    seg = torch.cat([torch.zeros(3, dtype=torch.bool), seg, torch.zeros(3, dtype=torch.bool)])
    for off in (offsets + 3, offsets[:1] + 3):
        want = merge_hits_plain(hits, seg, off, 20, 32)
        got = _emu_merge(chain_emu["merge_hits"], hits, seg, off, 20, 32)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(want[0].abs().sum()) == 0


@pytest.fixture(scope="module")
def long_runs_world():
    """An index whose repeat array gives runs of about 80 rows (longer
    than a warp's round of 32), and reads on it and off it."""
    return torch_chain_cases.long_runs_world()


@pytest.mark.parametrize("cutoff,maxh,cap", [(None, 192, None), (1000, 4000, 100),
                                             (1000, 40, 70), (3, 192, 3)],
                         ids=["filter-cutoff", "all-kept", "hit-overflow", "filtered"])
def test_walk_source_on_host_matches_plain(chain_emu, long_runs_world, cutoff, maxh, cap):
    """Hits, n_hits, total, good and overflow equal `walk_hits_plain`:
    at the index's filter cutoff (80, the repeat's runs of 80 rows walked
    over three rounds of 32, the repeat's reads past maxh); with maxh
    large enough for every kept hit; with maxh 40; and with a cutoff of 3
    that filters the repeat's strobes."""
    index, params, reads = long_runs_world
    views, planes = world_strobes(index, params, reads)
    cutoff = index.filter_cutoff if cutoff is None else cutoff
    cap = cutoff if cap is None else cap
    k = params.syncmer.k
    want = walk_hits_plain(*views[:7], *planes, k, cutoff, maxh, cap)
    got = _emu_walk(chain_emu["walk_hits"], (*views[:7], *planes), k, cutoff, maxh, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].sum()) > len(reads)
    assert bool(want[4].any()) == (maxh < 4000 and cutoff != 3)
    assert bool((want[2] > want[3]).any()) == (cutoff == 3)
    assert index.filter_cutoff == 80


def _emu_walk(lib, args, k, cutoff, maxh, cap):
    N = args[0].numel()
    shape = (args[2].numel(), 6) if maxh == 0 else (N, maxh, 6)
    got = [torch.full(shape, 7, dtype=torch.int32)] + [
        torch.full((N,), 7, dtype=torch.int32) for _ in range(3)] + [
        torch.full((N,), 7, dtype=torch.uint8)]
    assert lib.walk_hits_launch(
        *(x.data_ptr() for x in args[:7]), N, *(x.data_ptr() for x in args[7:]),
        args[7].numel(), k, cutoff, maxh, cap, *(x.data_ptr() for x in got), None) == 0
    got[4] = got[4].bool()
    return got


@pytest.mark.parametrize("cutoff,maxh,cap", [
    (1000, 4000, 100), (1000, 60, 100), (33, 600, 33), (1000, 4000, 40),
    (1000, 4000, LANE_ROWS), (1000, 4000, 2)],
    ids=["all-kept", "hit-overflow", "filtered", "cap-40", "cap-lane-rows", "cap-2"])
def test_walk_source_on_mixed_runs(chain_emu, cutoff, maxh, cap):
    """On a synthetic index of runs of 1, 2, 3, LANE_ROWS (the rows a lane
    walks alone), LANE_ROWS + 1, 33 and 80 rows, hit in random order by
    reads of up to 70 strobes, tie rows (count -1) among them: hits,
    n_hits, total, good and overflow equal `walk_hits_plain`, every kept
    hit in its strobe-major slot across runs that a lane finishes and
    runs that the warp finishes; with maxh 60 (overflow), the filter at
    33 (the 80-row runs filtered), and caps that cut runs at 40 rows, at
    LANE_ROWS and below it."""
    args, run_rows = mixed_runs()
    want = walk_hits_plain(*args, 20, cutoff, maxh, cap)
    got = _emu_walk(chain_emu["walk_hits"], args, 20, cutoff, maxh, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts = args[0].numpy()
    assert (counts == -1).any() and counts.max() > 32  # two rounds and more
    # a round of 32 strobes where a run the warp finishes comes before a
    # one-row run (both walked), so that the later slots move
    at = np.concatenate([[0], np.cumsum(np.maximum(counts, 0))])
    walked = (run_rows > 0) & (run_rows <= cutoff)
    mixed = False
    for b in range(len(counts)):
        for i0 in range(0, max(counts[b], 0), 32):
            rows = run_rows[at[b] + i0:min(at[b] + i0 + 32, at[b + 1])]
            ok = walked[at[b] + i0:at[b] + i0 + len(rows)]
            longs = np.flatnonzero(ok & (rows > LANE_ROWS))
            mixed |= len(longs) > 0 and bool((ok & (rows == 1))[longs[0]:].any())
    assert mixed
    assert int(want[1].sum()) > len(counts)
    assert bool(want[4].any()) == (maxh == 60)
    assert bool((want[2] > want[3]).any()) == (cutoff == 33)


@pytest.mark.parametrize("case,cutoff,cap", [
    ("world", None, None), ("mixed", 1000, 100), ("mixed", 33, 33),
    ("mixed", 1000, LANE_ROWS)],
    ids=["filter-cutoff", "mixed-runs", "mixed-runs-filtered", "mixed-runs-cap-lane-rows"])
def test_walk_source_compact_layout(chain_emu, long_runs_world, case, cutoff, cap):
    """At maxh 0, the main path's layout, each read's room is its own
    strobe count of rows at its strobe offset: the kernel's hits (T, 6),
    n_hits, total, good and overflow equal `walk_hits_plain`'s at maxh 0,
    whose rooms hold the dense layout's first hits of each read and
    overflow exactly where a read keeps more hits than it has strobes;
    `walk_hits_compact_plain`'s one buffer holds the same arrays. The
    repeat's reads of the index's own world, at its cutoff of 80, keep
    more hits than strobes, and so do reads on the mixed runs."""
    if case == "world":
        index, params, reads = long_runs_world
        views, planes = world_strobes(index, params, reads)
        args, k = (*views[:7], *planes), params.syncmer.k
        cutoff = cap = index.filter_cutoff
    else:
        args, k = mixed_runs()[0], 20
    want = walk_hits_plain(*args, k, cutoff, 0, cap)
    got = _emu_walk(chain_emu["walk_hits"], args, k, cutoff, 0, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    counts, offsets = (x.numpy() for x in args[:2])
    dense = walk_hits_plain(*args, k, cutoff, 4000, cap)
    room = np.maximum(counts, 0)
    n_kept = dense[1].numpy()
    assert (n_kept < 4000).all()
    assert np.array_equal(want[1].numpy(), np.minimum(n_kept, room))
    assert np.array_equal(want[4].numpy(), n_kept > room)
    for g, w in zip(want[2:4], dense[2:4]):
        assert torch.equal(g, w)
    for b in range(len(counts)):
        n = int(want[1][b])
        rows = want[0][offsets[b]:offsets[b] + room[b]]
        assert torch.equal(rows[:n], dense[0][b, :n]) and not rows[n:].any()
    assert want[4].any() and not want[4].all()
    buf = walk_hits_compact_plain(*args, k, cutoff, cap)
    assert buf.dtype == torch.int32 and buf.numel() == walk_words(len(counts), args[2].numel())
    for g, w in zip(walk_views(buf, len(counts), args[2].numel()), want):
        assert torch.equal(g, w.to(g.dtype))
