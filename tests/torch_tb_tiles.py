"""A numpy emulation of the traceback kernel's tile schedule
(rabbitsalign_tpu_torch/csrc/sw_traceback.cu), one pair at a time.

The walk reads its direction bytes only through two tile buffers that
persist across tiles (as the kernel's shared memory does, stale bytes and
all), filled as the kernel fills them: the tile anchored at (aq, at) holds
rows [max(0, aq-K+1), aq] and columns from max(0, at-K+1) (rounded down to
16 on the 16-byte path, which then copies whole 16-byte chunks up to
at | 15) to at. When the walk leaves its tile it takes the prefetched
diagonal tile, anchored at (q_hi - K, t_hi - K + K/4), if that holds the
new cell, else loads a tile anchored at the cell; nothing is prefetched
off the 16-byte path. Inside a tile the walk goes as the kernel's lanes
take it: in layer H a round reads up to 32 cells down the diagonal (lane
i the i-th, no further than the tile is sure to reach), takes the leading
diagonal ones at once and closes their EQ/X runs from the two ballots'
bit masks (Python ints here); gaps and the stop cell go one step at a
time. numpy only, shared by tests/test_torch_traceback.py and
chip_smoke.py (walk lengths, rounds and tile counts)."""

import numpy as np

RLE_M = 32
K_KERNEL = 32  # the kernel's tile rows (K in csrc/sw_traceback.cu)
OP_EQ, OP_X, OP_I, OP_D = 1, 2, 3, 4
_H = 0  # the walk's layer: H, else the source its gap layer forces (2 in E, 3 in F)


def tile_width(K: int) -> int:
    """The kernel's tile row stride: K usable columns after rounding the
    start down to 16, in whole 16-byte chunks."""
    return ((K + 14) // 16 + 1) * 16


def _load(buf, plane, aq, at, K, vec):
    """Copy the tile anchored at (aq, at) into buf; returns (q_lo, q_hi,
    t_lo, t_hi)."""
    q_lo = max(0, aq - K + 1)
    t_lo = max(0, at - K + 1)
    end = at + 1
    if vec:
        t_lo &= ~15
        end = (at | 15) + 1
        assert end <= plane.shape[1]
    buf[:aq - q_lo + 1, :end - t_lo] = plane[q_lo:aq + 1, t_lo:end]
    return (q_lo, aq, t_lo, at)


def _holds(w, q, t):
    return w is not None and w[0] <= q <= w[1] and w[2] <= t <= w[3]


def tile_walk(plane, score, t_end, q_end, K, vec, bufs):
    """Walk one pair's (Q, T) plane as the kernel does, with `bufs` two
    (K, tile_width(K)) u8 arrays standing for the warp's tiles. Returns
    (runs_op (RLE_M,), runs_len (RLE_M,), meta (8,)) int32 and a dict of
    the walk's steps, rounds (diagonal runs taken at once plus single
    steps), synchronous tile loads and prefetch hits."""
    runs_op = np.zeros(RLE_M, np.int32)
    runs_len = np.zeros(RLE_M, np.int32)
    meta = np.zeros(8, np.int32)
    stats = {"steps": 0, "rounds": 0, "loads": 0, "hits": 0}
    if score <= 0:
        return runs_op, runs_len, meta, stats
    T = plane.shape[1]
    vec = vec and T % 16 == 0

    def prefetch(w, buf):
        aq, at = w[1] - K, w[3] - K + K // 4
        if not vec or aq < 0 or at < 0:
            return None
        return _load(buf, plane, aq, at, K, True)

    t, q, layer = int(t_end), int(q_end), _H
    cur_op = cur_len = nrun = edits = 0
    ci = 0
    cur = _load(bufs[ci], plane, q, t, K, vec)
    stats["loads"] += 1
    pre = prefetch(cur, bufs[1 - ci])
    slot = np.zeros(RLE_M, np.int64)  # the warp's run slots: (len << 3) | op
    W = bufs[0].shape[1]
    s = OP_EQ  # the last step's source (1: diagonal)

    while True:
        # the next n steps stay in the tile
        n = min(q - cur[0], t - cur[2]) + 1
        off = (q - cur[0]) * W + (t - cur[2])
        tile = bufs[ci].reshape(-1)
        while n > 0:
            stats["rounds"] += 1
            if layer == _H:
                # lane i reads the i-th cell down the diagonal; ballots as ints
                m = min(n, 32)
                c = [int(tile[off - i * (W + 1)]) if i < m else 0 for i in range(32)]
                diag = sum(1 << i for i in range(32) if c[i] & 3 == 1)
                L = 0  # the leading diagonal lanes (the kernel's __ffs(~diag) - 1)
                while L < 32 and (diag >> L) & 1:
                    L += 1
                if L > 0:
                    live = (1 << L) - 1
                    eq = sum(1 << i for i in range(32) if (c[i] >> 4) & 1) & live
                    op0 = OP_EQ if eq & 1 else OP_X
                    bnd = (((eq ^ (eq << 1)) & live & ~1) | (op0 != cur_op)) & 0xFFFFFFFF
                    for lane in range(32):
                        before = bnd & ((1 << lane) - 1)
                        if (bnd >> lane) & 1 and (before or cur_op):
                            p = before.bit_length() - 1
                            op = OP_X - ((eq >> p) & 1) if before else cur_op
                            length = lane - p if before else cur_len + lane
                            r = RLE_M - 1 - nrun - bin(before).count("1") + (cur_op == 0)
                            if r >= 0:
                                slot[r] = (length << 3) | op
                    nrun += bin(bnd).count("1") - (cur_op == 0)
                    cur_len = L - (bnd.bit_length() - 1) if bnd else cur_len + L
                    cur_op = OP_X - ((eq >> (L - 1)) & 1)
                    edits += L - bin(eq).count("1")
                    stats["steps"] += L
                    off -= L * (W + 1)
                    q, t, n = q - L, t - L, n - L
                    continue
            # one step: a gap, or the stop cell
            cell = int(tile[off])
            s = cell & 3 if layer == _H else layer
            if s == 0:
                break
            op = s + 1  # I or D
            stats["steps"] += 1
            if op != cur_op:
                if cur_op and nrun < RLE_M:
                    slot[RLE_M - 1 - nrun] = (cur_len << 3) | cur_op
                nrun += cur_op != 0
                cur_op, cur_len = op, 0
            cur_len += 1
            edits += 1
            off -= W if s == 2 else 1
            q, t = q - (s == 2), t - (s == 3)
            layer = s if (cell >> s) & 1 else _H
            n -= 1
        if s == 0 or q < 0 or t < 0:  # a stop cell, or off the edge
            meta[0], meta[1] = t + 1, q + 1
            break
        if q < cur[0] or t < cur[2]:  # left the tile
            if _holds(pre, q, t):
                cur, ci = pre, 1 - ci
                stats["hits"] += 1
            else:
                cur = _load(bufs[ci], plane, q, t, K, vec)
                stats["loads"] += 1
            pre = prefetch(cur, bufs[1 - ci])
    if cur_op:
        if nrun < RLE_M:
            slot[RLE_M - 1 - nrun] = (cur_len << 3) | cur_op
        nrun += 1
    runs_op[:] = slot & 7
    runs_len[:] = slot >> 3
    meta[2], meta[3] = edits, nrun
    return runs_op, runs_len, meta, stats


def tile_walk_batch(dirs, score, t_end, q_end, K, vec=True, seed=0):
    """tile_walk over every pair of (B, Q, T) dirs, the tiles starting as
    seeded garbage: ((runs_op, runs_len (RLE_M, B), meta (8, B)) int32,
    per-pair stats as (B,) arrays)."""
    B = dirs.shape[0]
    rng = np.random.RandomState(seed)
    bufs = [rng.randint(0, 256, (K, tile_width(K))).astype(np.uint8) for _ in range(2)]
    runs_op = np.zeros((RLE_M, B), np.int32)
    runs_len = np.zeros((RLE_M, B), np.int32)
    meta = np.zeros((8, B), np.int32)
    stats = {k: np.zeros(B, np.int64) for k in ("steps", "rounds", "loads", "hits")}
    for b in range(B):
        o, n, m, s = tile_walk(dirs[b], int(score[b]), int(t_end[b]), int(q_end[b]), K, vec,
                               bufs)
        runs_op[:, b], runs_len[:, b], meta[:, b] = o, n, m
        for k in stats:
            stats[k][b] = s[k]
    return (runs_op, runs_len, meta), stats
