"""A numpy replay of the seeding kernel's schedule
(rabbitsalign_tpu_torch/csrc/seed_randstrobes.cu), lane by lane.

Pass 1, a warp a read: each lane owns a contiguous run of k-mer windows
and the s-mers that start there (the last lane also the s-mers past the
last window), rolls one value of k codes on both strands and the
position of its last N from its run's first code on, and takes each
s-mer as the last s codes of that value; it marks its syncmers in a bit
mask, a warp exclusive scan of their popcounts ranks them, and the list
goes to the read's scratch row. Pass 2, one block of 1024 threads: each
thread sums the counts of a contiguous run of tiles (four reads each), a
block scan places the runs, and each tile gets its offset. Pass 3, a warp
a read: the read's offset (its tile's, plus the reads before it in the
tile), then lane i links slots i, i + 32, ... of the read's
forward-then-reverse strobes and writes them there. The result is the
seeding buffer of ops/seed_device.py `strobe_views` (positions left
zero), as a numpy uint8 array. numpy only, shared by
tests/test_torch_seed.py."""

import numpy as np

from rabbitsalign_tpu_torch.ops.seed_device import strobe_bytes, strobes_at
from rabbitsalign_tpu_torch.seed.hash import popcount64, xxh64

WARP = 32
UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _roll(cs, starts, ends, m):
    """The rolled m-code values of each lane from its run's first code
    (lane arrays; a lane with starts >= ends pushes nothing): yields
    (the code just pushed, the lanes that pushed it, fwd, rev, last_n), as
    `Roller::push` leaves them."""
    mask = UMAX if m == 32 else np.uint64((1 << (2 * m)) - 1)
    shift = np.uint64(2 * (m - 1))
    fwd = np.zeros(WARP, np.uint64)
    rev = np.zeros(WARP, np.uint64)
    last_n = np.full(WARP, -1)
    live = starts < ends
    for u in range(int((ends - starts)[live].max(initial=0))):
        j = starts + u
        push = live & (j < ends)
        c = np.where(push, cs[np.minimum(j, cs.shape[0] - 1)], 0).astype(np.uint64)
        last_n = np.where(push & (c >= 4), j, last_n)
        c &= np.uint64(3)
        fwd = np.where(push, ((fwd << np.uint64(2)) | c) & mask, fwd)
        rev = np.where(push, (rev >> np.uint64(2)) | ((np.uint64(3) - c) << shift), rev)
        yield j, push, fwd.copy(), rev.copy(), last_n.copy()


def _syncmers(cs, n_len, k, s, t):
    """Pass 1's lanes for one read of n_len codes: (positions, k-mer
    hashes) of its syncmers in order, whether a window's minimum was
    duplicated, and each lane's runs and counts (for the tests)."""
    w = k - s + 1
    nk = n_len - k + 1
    ns = nk + w - 1
    lane = np.arange(WARP)
    per = -(-nk // WARP)
    p0 = lane * per
    p1 = np.minimum(p0 + per, nk)
    s1 = np.where(lane == WARP - 1, ns, np.minimum(p0 + per, ns))
    ends = np.maximum(s1 + s - 1, p1 + k - 1)  # pushes [p0, ends)
    smask = UMAX if s == 32 else np.uint64((1 << (2 * s)) - 1)
    sshift = np.uint64(2 * (k - s))
    sh = np.zeros(ns, np.uint64)
    kh = np.zeros(nk, np.uint64)
    kclean = np.zeros(WARP, np.int64)  # a bit a window of the lane's run
    for j, on, fwd, rev, last_n in _roll(cs, p0, np.where(p0 < s1, ends, p0), k):
        i = j - s + 1  # the s-mer that ends at code j
        put = on & (i >= p0) & (i < s1)
        h = np.where(last_n < i, xxh64(np.minimum(fwd & smask, rev >> sshift)), UMAX)
        sh[i[put]] = h[put]
        pos = j - k + 1  # the k-mer that ends at code j
        put = on & (pos >= p0) & (pos < p1)
        kh[pos[put]] = np.minimum(fwd, rev)[put]
        kclean |= (put & (last_n < pos)).astype(np.int64) << np.clip(pos - p0, 0, 62)
    emits = np.zeros(WARP, np.int64)
    dup = False
    for u in range(per):  # each lane its windows in order
        pos = p0 + u
        on = pos < p1
        win = np.stack([sh[np.minimum(pos + j, ns - 1)] for j in range(w)])
        mn = win.min(0)
        arg = (win == mn).argmax(0)
        ndup = (win == mn).sum(0)
        gate = on & ((kclean >> u) & 1).astype(bool) & (mn != UMAX)
        emit = gate & (arg == t - 1)
        emits |= emit.astype(np.int64) << u
        kh[pos[emit]] = xxh64(kh[pos[emit]])
        dup |= bool((gate & (ndup > 1)).any())
    mine = np.array([bin(e).count("1") for e in emits])
    incl = np.cumsum(mine)  # the warp scan (shfl_up rounds give the same sums)
    first = incl - mine
    pos_list, hash_list = [], []
    for ln in range(WARP):
        bits = [b for b in range(per) if emits[ln] >> b & 1]
        assert len(bits) == mine[ln] and first[ln] == len(pos_list)
        pos_list += [int(p0[ln]) + b for b in bits]
        hash_list += [kh[int(p0[ln]) + b] for b in bits]
    return (np.array(pos_list, np.int64), np.array(hash_list, np.uint64), dup,
            {"per": per, "lane_counts": mine, "pushes": int((ends - p0)[p0 < s1].max())})


def _link(ps, hs, n, n_out, length, k, w_min, w_max, q, max_dist, key_mult):
    """Pass 3's slots of one read: (hash, start, end, is_rev) a slot, in
    slot order, as its lanes compute them."""
    out = []
    for j in range(2 * n_out):  # lane j % 32, round j // 32
        strand = int(j >= n_out)
        m = j - strand * n_out

        def entry(i):
            src = n - 1 - i if strand else i
            return (length - int(ps[src]) - k if strand else int(ps[src])), hs[src]

        p1, h1 = entry(m)
        best, p2, h2 = 0x7FFFFFFF, p1, h1
        for d in range(w_min, w_max + 1):
            if m + d >= n:
                break
            jp, jh = entry(m + d)
            if jp > p1 + max_dist:
                continue
            key = int(popcount64((h1 ^ jh) & np.uint64(q))) * key_mult + (d - w_min)
            if key < best:
                best, p2, h2 = key, jp, jh
        with np.errstate(over="ignore"):
            out.append((np.uint64(h1 + h2), p1, p2 + k, strand))
    return out


TILE = 4  # reads a tile, a block of passes 1 and 3 (kWarps)
SCAN_THREADS = 1024


def _offsets(counts):
    """Pass 2 and the offsets of pass 3: each of 1024 threads sums the
    counts of a contiguous run of tiles, a block scan (32 warps of 32)
    places the runs and gives each tile its offset and the total; a read's
    offset is its tile's plus the counts of the reads before it in the
    tile. Returns (offsets, total)."""
    n = counts.shape[0]
    c = np.maximum(counts.astype(np.int64), 0)
    n_tiles = -(-n // TILE)
    tile = np.array([c[t * TILE:(t + 1) * TILE].sum() for t in range(n_tiles)], np.int64)
    per = -(-n_tiles // SCAN_THREADS)
    sums = np.array([tile[i * per:(i + 1) * per].sum() for i in range(SCAN_THREADS)])
    warp_incl = sums.reshape(-1, WARP).cumsum(1)
    warp_tot = np.cumsum(warp_incl[:, -1])
    excl = (warp_incl - sums.reshape(-1, WARP)).ravel() + np.repeat(
        np.concatenate([[0], warp_tot[:-1]]), WARP)
    tile_at = np.zeros(n_tiles, np.int64)
    for i in range(SCAN_THREADS):
        at = excl[i]
        for t in range(i * per, min((i + 1) * per, n_tiles)):
            tile_at[t] = at
            at += tile[t]
    offsets = np.array([tile_at[r // TILE] + c[r - r % TILE:r].sum() for r in range(n)], np.int64)
    return offsets, int(excl[-1] + sums[-1])


def seed_lanes(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M):
    """The kernel's three passes on codes (N, L) uint8 and lengths (N,)
    int32 (-1: longer than L). Returns (buffer as `strobe_views` lays it
    out, strobe_bytes(N, total) long, positions zero; total; per-read
    lane runs and counts of pass 1, None where pass 1 returned early)."""
    N, L = codes.shape
    key_mult = 1
    while key_mult < w_max - w_min + 1:
        key_mult *= 2
    counts = np.zeros(N, np.int32)
    lists, lanes = [], []
    for b in range(N):
        length = int(lengths[b])
        n_len = min(length, L)
        if length < 0 or n_len - k + 1 <= 0:
            counts[b] = -1 if length < 0 else 0
            lists.append(None)
            lanes.append(None)
            continue
        ps, hs, dup, lane = _syncmers(codes[b], n_len, k, s, t)
        count = ps.shape[0]
        tie = dup or count > M
        n = count if length >= w_max else 0
        n_out = max(n - w_min, 0)
        counts[b] = -1 if tie else 2 * n_out
        lists.append(None if tie or n_out == 0 else (ps, hs, n, n_out))
        lanes.append(lane)
    offsets, total = _offsets(counts)
    buf = np.zeros(strobe_bytes(N, total), np.uint8)
    at = strobes_at(N)
    buf[:8].view(np.int64)[0] = total
    buf[8:8 + 4 * N].view(np.int32)[:] = counts
    buf[at - 8 * N:at].view(np.int64)[:] = offsets
    hashes = buf[at:at + 8 * total].view(np.uint64)
    starts = buf[at + 16 * total:at + 20 * total].view(np.int32)
    ends = buf[at + 20 * total:at + 24 * total].view(np.int32)
    is_rev = buf[at + 24 * total:at + 25 * total]
    for b, entry in enumerate(lists):
        if entry is None:
            continue
        ps, hs, n, n_out = entry
        for j, (h, st, en, rv) in enumerate(_link(ps, hs, n, n_out, int(lengths[b]), k, w_min,
                                                  w_max, q, max_dist, key_mult)):
            o = offsets[b] + j
            hashes[o], starts[o], ends[o], is_rev[o] = h, st, en, rv
    return buf, total, lanes
