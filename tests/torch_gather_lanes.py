"""A numpy replay of the run gather of csrc/find_runs.cu
(`gather_runs_kernel`), lane by lane, one warp at a time.

A thread takes a key (blocks of 256, so the grid covers nq rounded up to
whole blocks, and lanes past nq take no key); a found key with dst >= 0
copies its first n = min(count, cap) run rows to dst onwards. A lane with
n <= K_WARP_RUN copies its rows itself; the lanes with longer runs are
taken from the warp's ballot lowest lane first, and the whole warp copies
each such run, lane i rows i, i + 32, ... Also `RunsIndex`, an index
whose runs take each side of that choice. numpy only, shared by
tests/test_torch_sharded_index.py, tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np

WARP = 32
BLOCK = 256  # threads a block (gather_runs_launch)
K_WARP_RUN = 8  # kWarpRun: longer runs are copied by the whole warp


def gather_lanes(positions, packed, gpos, count, start, cap, dst, out_pos, out_packed):
    """Copy as the kernel's lanes do, into out_pos and out_packed (flat
    numpy arrays, in place). positions and packed (m,), gpos, count and
    dst (nq,) int64 (dst None: key * cap). Returns the schedule's
    counts: rows copied by single lanes, rows copied by whole warps, and
    the warp steps (32 rows or fewer) those took."""
    nq = count.shape[0]
    n_threads = -(-nq // BLOCK) * BLOCK
    stats = {"thread_rows": 0, "warp_rows": 0, "warp_steps": 0}
    lane_ids = np.arange(WARP)
    for w0 in range(0, n_threads, WARP):
        key = w0 + lane_ids
        live = key < nq
        k = np.where(live, key, 0)
        c = np.where(live, count[k], 0)
        d = np.where(live, key * cap if dst is None else dst[k], 0)
        take = (c > 0) & (d >= 0)
        n = np.where(take, np.minimum(c, cap), 0)
        src = np.where(take, gpos[k] - start, 0)
        by_warp = n > K_WARP_RUN
        for lane in np.flatnonzero(~by_warp & (n > 0)):  # each lane its own rows
            rows = np.arange(n[lane])
            out_pos[d[lane] + rows] = positions[src[lane] + rows]
            out_packed[d[lane] + rows] = packed[src[lane] + rows]
            stats["thread_rows"] += int(n[lane])
        ball = int(np.sum(by_warp.astype(np.int64) << lane_ids))
        while ball:
            leader = (ball & -ball).bit_length() - 1
            ball &= ball - 1
            wn, wd, ws = int(n[leader]), int(d[leader]), int(src[leader])
            for r0 in range(0, wn, WARP):
                rows = r0 + lane_ids[r0 + lane_ids < wn]
                out_pos[wd + rows] = positions[ws + rows]
                out_packed[wd + rows] = packed[ws + rows]
                stats["warp_steps"] += 1
            stats["warp_rows"] += wn
    return stats


class RunsIndex:
    """An index of runs of 1, 31, 32, 33 and more than `cap` rows, and
    short ones between, with the bucket table StrobemerIndex builds
    (bucket b covers the hashes whose top `bits` equal b)."""

    bits = 3
    filter_cutoff = 1000

    def __init__(self, cap: int = 40):
        lens = np.array([1, 31, 2, 32, 9, 33, 1, cap + 17, 3, 8, 1, 2 * cap + 40, 1])
        vals = np.sort(np.random.RandomState(8).randint(0, 2**63, lens.size).astype(np.uint64))
        self.hashes = np.repeat(vals, lens)
        n = self.hashes.shape[0]
        self.positions = np.arange(n, dtype=np.uint32) * np.uint32(3)
        self.packed = np.arange(n, dtype=np.uint32) << np.uint32(8)
        tops = (self.hashes >> np.uint64(64 - self.bits)).astype(np.int64)
        self.randstrobe_start_indices = np.searchsorted(
            tops, np.arange((1 << self.bits) + 1)).astype(np.uint64)
