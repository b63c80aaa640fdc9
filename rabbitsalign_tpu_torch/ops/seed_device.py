"""Device seeding for ``--device-seed``: both strands' randstrobes of a
padded read batch, compacted, and their index lookup, as plain PyTorch
functions on tensors (the device is the tensors'), plus `seed_and_find`,
which runs the two through their CUDA kernels (ops/seed_cuda.py) into one
buffer for the engine's preseeded phase A.

Counterparts of rabbitsalign_tpu/ops/seed_device.py: `xxh64_u64` (:35),
`randstrobes_query_vec` (:432), `index_find_device` (:239) and
`seed_and_find` (:555, whose compaction is `compact_strobes`). Their
outputs equal the JAX functions' exactly; `seed_and_find` writes its
arrays into one buffer (`strobe_views`).

torch has no unsigned 64-bit shifts, compares, searchsorted or popcount,
so a uint64 is carried as the int64 with the same bits: addition,
multiplication and left shifts wrap alike; a logical right shift is an
arithmetic shift and a mask (`lsr`); unsigned order is signed order after
an xor with 1 << 63 (`flip`); popcount is a SWAR sum (`popcount64`).
"""

from __future__ import annotations

from typing import Tuple

import torch

I64 = torch.int64
SIGN = -(1 << 63)  # int64 bits of 1 << 63
UMAX = -1  # int64 bits of 2**64 - 1
UMAX_FLIPPED = (1 << 63) - 1  # flip(UMAX)
INT32_MAX = 0x7FFFFFFF


def as_i64(u: int) -> int:
    """The int64 with the bits of the uint64 `u`."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >> 63 else u


P1 = as_i64(0x9E3779B185EBCA87)
P2 = as_i64(0xC2B2AE3D27D4EB4F)
P3 = as_i64(0x165667B19E3779F9)
P4 = as_i64(0x85EBCA77C2B2AE63)
P5_PLUS_8 = as_i64(0x27D4EB2F165667C5 + 8)


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of uint64 bits carried as int64, 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | lsr(x, 64 - r)


def flip(x: torch.Tensor) -> torch.Tensor:
    """uint64 bits -> int64 in the same order (an involution)."""
    return x ^ SIGN


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(flip(a) < flip(b), a, b)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    x = x - (lsr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (lsr(x, 2) & 0x3333333333333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return lsr(x * 0x0101010101010101, 56)


def xxh64_u64(x: torch.Tensor) -> torch.Tensor:
    """xxh64 of one uint64 (seed/hash.py, reference src/hash.hpp:110-123)
    on int64 bits, wrapping mod 2**64."""
    x = rotl(x.to(I64) * P2, 31)
    r = rotl(P5_PLUS_8 ^ (x * P1), 27)
    r = r * P1 + P4
    r = r ^ lsr(r, 33)
    r = r * P2
    r = r ^ lsr(r, 29)
    r = r * P3
    return r ^ lsr(r, 32)


def _canonical_hashes(c64: torch.Tensor, m: int) -> torch.Tensor:
    """xxh64 of the canonical m-mer at every start position (N codes make
    garbage there; the callers mask those windows)."""
    B, L = c64.shape
    n = L - m + 1
    fwd = torch.zeros((B, n), dtype=I64, device=c64.device)
    rc = torch.zeros_like(fwd)
    for j in range(m):  # no dependency across positions
        cj = c64[:, j:j + n]
        fwd = fwd * 4 + cj
        rc = rc + ((3 - cj) << (2 * j))
    return xxh64_u64(umin(fwd, rc))


def _clean(isn_prefix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(B, n): no N in [p, p + m)."""
    return (isn_prefix[:, m:m + n] - isn_prefix[:, :n]) == 0


def randstrobes_query_vec(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                          w_min: int, w_max: int, q: int, max_dist: int, M: int
                          ) -> Tuple[torch.Tensor, ...]:
    """Both strands' query randstrobes of a read batch (reference
    src/randstrobes.cpp:207-253) in closed form.

    codes (B, L) uint8 in {0..3, 4 = N}, lengths (B,) int32. Returns
    (hash (B, 2M) int64 with uint64 bits, start (B, 2M) int32, end (B, 2M)
    int32, n_fwd (B,) int32, n_rc (B,) int32, tie (B,) bool). Slots
    [0, n_fwd) and [M, M + n_rc) hold the forward and the reverse strobes;
    every other slot holds hash 0, start -1 and end -1 (the JAX function
    leaves whatever its arithmetic gave there). A `tie` row has a k-mer
    window whose minimum s-mer hash is duplicated, whose tie the host's
    min-queue breaks by its history, or more than M syncmers: its strobes
    must come from the host. Requires s <= k <= 32."""
    B, L = codes.shape
    dev = codes.device
    w = k - s + 1
    nk = L - k + 1
    if nk <= 0:  # no k-mer fits: nothing is emitted
        codes = torch.cat([codes, torch.full((B, k - L), 4, dtype=codes.dtype, device=dev)], 1)
        return randstrobes_query_vec(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M)
    c64 = codes.to(I64)
    shash = _canonical_hashes(c64, s)
    khash = _canonical_hashes(c64, k)
    isn = torch.cat([torch.zeros((B, 1), dtype=I64, device=dev),
                     torch.cumsum((codes >= 4).to(I64), 1)], 1)
    sclean = _clean(isn, s, L - s + 1)
    kclean = _clean(isn, k, nk)
    inlen = (torch.arange(nk, device=dev)[None, :] + k) <= lengths[:, None]

    # the minimum s-mer hash of each k-mer window: leftmost argmin and the
    # number of times it occurs
    sh = flip(torch.where(sclean, shash, UMAX))
    stack = torch.stack([sh[:, j:j + nk] for j in range(w)])  # (w, B, nk)
    mn = stack.min(0).values
    eq = stack == mn[None]
    arg = torch.full_like(mn, w)
    for j in reversed(range(w)):
        arg = torch.where(eq[j], j, arg)
    ndup = eq.sum(0)
    gate = kclean & inlen & (mn != UMAX_FLIPPED)
    # the automaton tracks s-mer start positions; emission at offset t-1
    emit = gate & (arg == t - 1)
    ce = torch.cumsum(emit.to(I64), 1)
    tie = (gate & (ndup > 1)).any(1) | (ce[:, -1] > M)

    # slot m: the (m + 1)-th syncmer's position (0 past the last)
    n_sync = torch.where(lengths >= w_max, ce[:, -1], 0)
    targets = torch.arange(1, M + 1, device=dev).expand(B, M).contiguous()
    slot_pos = torch.searchsorted(ce, targets)
    slot_pos = torch.where(slot_pos < nk, slot_pos, 0)
    sync_pos = slot_pos.to(torch.int32)
    sync_hash = torch.gather(khash, 1, slot_pos)

    # packed tie key = popcount * mult + window offset; mult exceeds the
    # window width, so the popcount classes stay disjoint
    key_mult = 1
    while key_mult < w_max - w_min + 1:
        key_mult *= 2
    midx = torch.arange(M, device=dev)[None, :]
    qmask = as_i64(q)

    def link(pos, hsh):
        res_h = torch.zeros((B, M), dtype=I64, device=dev)
        res_e = torch.zeros((B, M), dtype=torch.int32, device=dev)
        best = torch.full((B, M), INT32_MAX, dtype=torch.int32, device=dev)
        for d in range(w_min, w_max + 1):
            jpos = torch.roll(pos, -d, 1)
            jh = torch.roll(hsh, -d, 1)
            ok = (midx + d < n_sync[:, None]) & (jpos <= pos + max_dist)
            pc = popcount64((hsh ^ jh) & qmask).to(torch.int32)
            key = torch.where(ok, pc * key_mult + (d - w_min), INT32_MAX)
            upd = key < best
            best = torch.where(upd, key, best)
            res_h = torch.where(upd, hsh + jh, res_h)
            res_e = torch.where(upd, jpos, res_e)
        none = best == INT32_MAX  # no in-range strobe 2: self-link
        res_h = torch.where(none, hsh + hsh, res_h)
        res_e = torch.where(none, pos, res_e)
        return res_h, res_e

    fh, f2 = link(sync_pos, sync_hash)
    # reverse strand: the syncmer list reversed, positions mirrored
    rev_idx = (n_sync[:, None] - 1 - midx).clamp(0, M - 1)
    rpos = (lengths[:, None] - torch.gather(sync_pos, 1, rev_idx) - k).to(torch.int32)
    bh, b2 = link(rpos, torch.gather(sync_hash, 1, rev_idx))

    valid = (midx + w_min) < n_sync[:, None]
    n_out = valid.sum(1).to(torch.int32)
    valid = torch.cat([valid, valid], 1)
    return (torch.where(valid, torch.cat([fh, bh], 1), 0),
            torch.where(valid, torch.cat([sync_pos, rpos], 1), -1),
            torch.where(valid, torch.cat([f2, b2], 1) + k, -1),
            n_out, n_out.clone(), tie)


def index_find_device(index_hashes: torch.Tensor, bucket_starts: torch.Tensor, bits: int,
                      query_hashes: torch.Tensor) -> torch.Tensor:
    """StrobemerIndex.find for a batch: the first position of each query's
    hash in the sorted index (int64), or -1, with the bucket table's quirk
    (the run of the globally smallest hash is unreachable; an index whose
    hashes are all equal finds nothing; index/strobemer_index.py
    `_build_buckets`). All arrays int64 with uint64 bits on one device;
    index_hashes (n,), bucket_starts (2**bits + 1,), queries any shape."""
    n = index_hashes.shape[0]
    if n == 0:
        return torch.full_like(query_hashes, -1)
    pos = torch.searchsorted(flip(index_hashes), flip(query_hashes))
    tops = lsr(query_hashes, 64 - bits)
    lo = bucket_starts[tops]
    hi = bucket_starts[tops + 1]
    in_range = (pos >= lo) & (pos < hi) & (pos < n)
    found = in_range & (index_hashes[torch.where(pos < n, pos, 0)] == query_hashes)
    return torch.where(found, pos, -1)


def compact_strobes(h: torch.Tensor, st: torch.Tensor, en: torch.Tensor, nf: torch.Tensor,
                    nr: torch.Tensor, tie: torch.Tensor, lengths: torch.Tensor, M: int
                    ) -> Tuple[torch.Tensor, ...]:
    """The valid slots of `randstrobes_query_vec`'s output, in the layout
    the engine's preseeded phase A reads (the compaction of the JAX
    package's seed_and_find, :555). lengths (N,) int32, -1 for a read
    longer than L. Returns (counts (N,) int32, -1 for a tie row or a long
    read, which the engine seeds itself; offsets (N,) int64; hashes int64
    with uint64 bits, starts int32, ends int32, is_rev uint8, one entry a
    strobe: each read's forward strobes, then its reverse ones)."""
    row_ok = ~(tie | (lengths < 0))
    n_strobes = torch.where(row_ok, nf + nr, 0)
    counts = torch.where(row_ok, nf + nr, -1).to(torch.int32)
    offsets = torch.cumsum(n_strobes.to(I64), 0) - n_strobes
    slot = torch.arange(2 * M, device=h.device)[None, :]
    valid = torch.where(slot < M, slot < nf[:, None], slot - M < nr[:, None]) & row_ok[:, None]
    idx = valid.flatten().nonzero().squeeze(1)
    is_rev = (slot >= M).expand(valid.shape).flatten()[idx].to(torch.uint8)
    return counts, offsets, h.flatten()[idx], st.flatten()[idx], en.flatten()[idx], is_rev


def _a8(n: int) -> int:
    return (n + 7) // 8 * 8


def strobes_at(n_reads: int) -> int:
    """Byte offset of the strobe sections in a seeding buffer: the total
    (int64), counts (N,) int32 padded to 8 bytes and offsets (N,) int64
    come first."""
    return 8 + _a8(4 * n_reads) + 8 * n_reads


def strobe_bytes(n_reads: int, total: int) -> int:
    """Bytes of a seeding buffer that hold the arrays of `total` strobes:
    the five sections (hashes, positions, starts, ends, is_rev) lie back
    to back, 25 bytes a strobe."""
    return strobes_at(n_reads) + 25 * total


def strobe_views(buf: torch.Tensor, n_reads: int, total: int) -> Tuple[torch.Tensor, ...]:
    """The arrays of a seeding buffer (uint8, on any device; the layout of
    csrc/seed_randstrobes.cu): (counts (N,) int32, offsets (N,) int64,
    hashes int64, starts int32, ends int32, is_rev uint8, positions
    int64), views into `buf`, the strobe arrays `total` long, in the order
    `chunk_a_fx_pre` takes them."""
    at = strobes_at(n_reads)
    c0 = 8
    o0 = 8 + _a8(4 * n_reads)

    def view(start: int, n: int, dtype: torch.dtype) -> torch.Tensor:
        return buf[start:start + n * dtype.itemsize].view(dtype)

    t = total
    return (view(c0, n_reads, torch.int32), view(o0, n_reads, I64), view(at, t, I64),
            view(at + 16 * t, t, torch.int32), view(at + 20 * t, t, torch.int32),
            view(at + 24 * t, t, torch.uint8), view(at + 8 * t, t, I64))


def seed_strobes_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                       w_min: int, w_max: int, q: int, max_dist: int, M: int
                       ) -> Tuple[torch.Tensor, int]:
    """The plain version of csrc/seed_randstrobes.cu: `randstrobes_query_vec`
    on the batch, then `compact_strobes`, written into a seeding buffer
    (`strobe_views`) of `strobe_bytes` with the positions zero. codes
    (N, L) uint8, lengths (N,) int32 (-1: longer than L). Returns
    (buffer, total)."""
    out = randstrobes_query_vec(codes, lengths.clamp(min=0), k, s, t, w_min, w_max, q,
                                max_dist, M)
    arrays = compact_strobes(*out, lengths, M)
    n, total = codes.shape[0], arrays[2].numel()
    buf = torch.zeros(strobe_bytes(n, total), dtype=torch.uint8, device=codes.device)
    buf[:8].view(I64)[0] = total
    for view, a in zip(strobe_views(buf, n, total), arrays):
        view.copy_(a)
    return buf, total


def seed_and_find(codes: torch.Tensor, lengths: torch.Tensor, index_hashes: torch.Tensor,
                  bucket_starts: torch.Tensor, k: int, s: int, t: int, w_min: int, w_max: int,
                  q: int, max_dist: int, M: int, bits: int) -> Tuple[torch.Tensor, int]:
    """Device seeding and index lookup for one chunk (--device-seed), in
    the layout the engine's preseeded phase A reads.

    codes (N, L) uint8 and lengths (N,) int32 (-1: longer than L), as
    `NativeEngine.fx_codes` exports them, on the device of the resident
    index arrays. The seeding kernel writes the counts, offsets and
    compacted strobes into one buffer (the chunk's one host sync reads
    their total), and the lookup kernel writes each strobe's index
    position beside them. Returns (buffer, total): the buffer's first
    `strobe_bytes(N, total)` bytes hold the arrays of `strobe_views`, so
    one copy brings them to the host. CPU tensors take the plain
    versions."""
    from .seed_cuda import index_find, seed_randstrobes

    buf, total = seed_randstrobes(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M)
    views = strobe_views(buf, codes.shape[0], total)
    index_find(index_hashes, bucket_starts, bits, views[2], out=views[6])
    return buf[:strobe_bytes(codes.shape[0], total)], total


# --- the exact scan seeder and the split lookups --------------------------
#
# Counterparts of the JAX package's test-only seeding variants
# (rabbitsalign_tpu/ops/seed_device.py): the syncmer automaton as a scan,
# which is exact on the rows that `randstrobes_query_vec` flags as ties,
# the linking as window ops, and the index lookup over (hi32, lo32) hash
# planes, by binary and by G-ary search. No mapping path runs them.

def syncmers_scan_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                        M: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of csrc/syncmers_scan.cu: canonical closed
    syncmers by the reference's automaton (SyncmerIterator, reference
    src/randstrobes.cpp:57-118; seed/syncmers.py `syncmers_slow`), one
    step a base over the whole batch, as the JAX package's
    `syncmers_device` (:58) scans. Its min-queue breaks ties between
    equal minimum s-mer hashes by its history: leftmost on a window's
    first fill, rightmost on the rescan after the minimum slid out, the
    old one when a new hash only equals it.

    codes (B, L) uint8 {0..3, 4 = N}, lengths (B,) int32. Returns
    (positions (B, M) int32, -1 past the count; hashes (B, M) int64 with
    the uint64 bits, 0 past the count; counts (B,) int32). Syncmers past
    the M-th are dropped (M = L is always enough)."""
    B, L = codes.shape
    dev = codes.device
    w = k - s + 1
    kmask, smask = as_i64((1 << (2 * k)) - 1), as_i64((1 << (2 * s)) - 1)
    kshift, sshift = 2 * (k - 1), 2 * (s - 1)
    zero = torch.zeros(B, dtype=I64, device=dev)
    xk0, xk1, xs0, xs1 = zero, zero, zero, zero
    run = torch.zeros(B, dtype=I64, device=dev)  # bases since the last N
    ring = torch.full((B, w), UMAX, dtype=I64, device=dev)  # slot 0 the oldest
    minval = torch.full((B,), UMAX, dtype=I64, device=dev)
    minpos = torch.full((B,), -1, dtype=I64, device=dev)
    lens = lengths.to(I64)
    counts = torch.zeros(B, dtype=I64, device=dev)
    out_pos = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    out_hash = torch.zeros((B, M), dtype=I64, device=dev)
    rows = torch.arange(B, device=dev)
    c64 = codes.to(I64)
    for i in range(L):
        c = c64[:, i]
        base = c < 4
        cc = torch.where(base, c, 0)
        xk0 = torch.where(base, ((xk0 << 2) | cc) & kmask, 0)
        xk1 = torch.where(base, lsr(xk1, 2) | ((3 - cc) << kshift), 0)
        xs0 = torch.where(base, ((xs0 << 2) | cc) & smask, 0)
        xs1 = torch.where(base, lsr(xs1, 2) | ((3 - cc) << sshift), 0)
        run = torch.where(base, run + 1, 0)
        have = base & (run >= s)
        hash_s = xxh64_u64(umin(xs0, xs1))
        ring = torch.where(have[:, None], torch.cat([ring[:, 1:], hash_s[:, None]], 1), ring)
        n_smers = run - (s - 1)
        first_full = have & (n_smers == w)
        steady = have & (n_smers > w)
        fr = flip(ring)
        left = fr.argmin(1)  # the first of equal minima
        right = (w - 1) - fr.flip(1).argmin(1)  # the last
        slid_out = steady & (minpos == i - k)
        take_new = steady & ~slid_out & (flip(hash_s) < flip(minval))
        left_val = ring.gather(1, left[:, None])[:, 0]
        right_val = ring.gather(1, right[:, None])[:, 0]
        minval = torch.where(first_full, left_val, torch.where(
            slid_out, right_val, torch.where(take_new, hash_s, minval)))
        minpos = torch.where(first_full, i - k + 1 + left, torch.where(
            slid_out, i - k + 1 + right, torch.where(take_new, i - s + 1, minpos)))
        minval = torch.where(base, minval, UMAX)
        minpos = torch.where(base, minpos, -1)
        emit = (first_full | steady) & (minpos == i - k + t) & (i < lens) & (counts < M)
        if bool(emit.any()):
            at = rows[emit]
            slot = counts[emit]
            out_pos[at, slot] = i - k + 1
            out_hash[at, slot] = xxh64_u64(umin(xk0[emit], xk1[emit]))
            counts = counts + emit.to(I64)
    return out_pos, out_hash, counts.to(torch.int32)


def syncmers_device(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                    max_syncmers: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical closed syncmers of a read batch, exact (the JAX
    package's `syncmers_device`, :58): CPU tensors take
    `syncmers_scan_plain`, CUDA tensors the kernel csrc/syncmers_scan.cu
    (ops/seed_cuda.py `syncmers_scan`). Returns (positions (B, M) int32,
    hashes (B, M) int64, counts (B,) int32), M = max_syncmers."""
    from .seed_cuda import syncmers_scan

    return syncmers_scan(codes, lengths, k, s, t, max_syncmers)


def link_randstrobes_device(positions: torch.Tensor, hashes: torch.Tensor, counts: torch.Tensor,
                            w_min: int, w_max: int, q: int, max_dist: int, k: int
                            ) -> Tuple[torch.Tensor, ...]:
    """Randstrobe linking of a batch of syncmer lists as window ops (the
    JAX package's `link_randstrobes_device`, :165; seed/randstrobes.py
    `link_randstrobes`): strobe 2 of syncmer i is the syncmer j in
    [i + w_min, min(i + w_max, n - 1)] with pos <= pos_i + max_dist of
    least popcount((h_i ^ h_j) & q), the leftmost on ties; an empty window
    links i to itself. positions (B, M) int32, hashes (B, M) int64 bits,
    counts (B,) int32. Returns (hash (B, M) int64, p1 (B, M) int32, p2
    (B, M) int32, n_out (B,) int32): slot m pairs syncmer m, valid for
    m < n_out = max(0, count - w_min); the other slots hold what the same
    arithmetic gives there, as in the JAX function."""
    B, M = hashes.shape
    dev = hashes.device
    width = w_max - w_min + 1
    idx = torch.arange(M, device=dev)[None, :]
    j_idx = idx[:, :, None] + w_min + torch.arange(width, device=dev)[None, None, :]
    cnt = counts.to(I64)[:, None, None]
    j_clip = torch.minimum(j_idx, (cnt - 1).clamp(min=0))
    valid = j_idx < cnt
    cand_pos = positions.gather(1, j_clip.reshape(B, -1)).reshape(B, M, width)
    valid = valid & (cand_pos <= positions[:, :, None] + max_dist)
    cand_hash = hashes.gather(1, j_clip.reshape(B, -1)).reshape(B, M, width)
    metric = popcount64((hashes[:, :, None] ^ cand_hash) & as_i64(q))
    metric = torch.where(valid, metric, 1 << 40)
    best = metric.argmin(2)  # the leftmost of equal minima
    strobe2 = torch.where(valid.any(2), idx + w_min + best, idx).clamp(max=M - 1)
    h2 = hashes.gather(1, strobe2)
    p2 = positions.gather(1, strobe2)
    return hashes + h2, positions, p2, (counts - w_min).clamp(min=0)


def randstrobes_query_device(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                             w_min: int, w_max: int, q: int, max_dist: int, max_syncmers: int
                             ) -> Tuple[torch.Tensor, ...]:
    """Both strands' query randstrobes of a read batch through the exact
    scan seeder (the JAX package's `randstrobes_query_device`, :202;
    reference src/randstrobes.cpp:207-253): `syncmers_device`, then
    `link_randstrobes_device` on the list and on the list reversed with
    positions mirrored. Exact on the rows `randstrobes_query_vec` flags.
    Returns (hash (B, 2M) int64 bits, start (B, 2M) int32, end (B, 2M)
    int32, is_rc (B, 2M) bool, n_fwd (B,) int32, n_rc (B,) int32); slots
    [0, n_fwd) and [M, M + n_rc) are valid. Reads shorter than w_max give
    nothing."""
    B = codes.shape[0]
    pos, h, counts = syncmers_device(codes, lengths, k, s, t, max_syncmers)
    counts = torch.where(lengths >= w_max, counts, 0)
    M = pos.shape[1]
    fh, f1, f2, n_fwd = link_randstrobes_device(pos, h, counts, w_min, w_max, q, max_dist, k)
    # reverse strand: the syncmer list reversed, positions mirrored
    src = counts.to(I64)[:, None] - 1 - torch.arange(M, device=codes.device)[None, :]
    src_clip = src.clamp(min=0)
    rpos = torch.where(src >= 0, lengths[:, None] - pos.gather(1, src_clip) - k, -1)
    rh = torch.where(src >= 0, h.gather(1, src_clip), 0)
    bh, b1, b2, n_rc = link_randstrobes_device(rpos.to(torch.int32), rh, counts, w_min, w_max,
                                               q, max_dist, k)
    is_rc = torch.zeros((B, 2 * M), dtype=torch.bool, device=codes.device)
    is_rc[:, M:] = True
    return (torch.cat([fh, bh], 1), torch.cat([f1, b1], 1), torch.cat([f2 + k, b2 + k], 1),
            is_rc, n_fwd, n_rc)


def split_hash_u64(hashes):
    """A sorted uint64 hash array (numpy) as its (hi32, lo32) uint32
    planes, for the split lookups below (once an index)."""
    import numpy as np

    h = np.asarray(hashes, dtype=np.uint64)
    return (h >> np.uint64(32)).astype(np.uint32), h.astype(np.uint32)


def gary_iters(bucket_starts, G: int = 16) -> int:
    """The narrowing steps `index_find_device_gary` needs, so that the
    final G-slice covers the largest bucket run (host side, numpy)."""
    import numpy as np

    runs = np.diff(np.asarray(bucket_starts, dtype=np.int64))
    w = int(runs.max()) if runs.size else 0
    iters = 0
    while w > G - 1:
        w = -(-w // G)
        iters += 1
    return iters


def hash_planes(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hashes (int64 with the uint64 bits) as the (hi32, lo32) query
    planes of the split lookups: int32 tensors with the uint32 bits."""
    def bits32(x):
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)

    return bits32(lsr(h, 32)), bits32(h & 0xFFFFFFFF)


def _ordered32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits carried as int32 -> int32 in the same order."""
    return x ^ -(1 << 31)


def _top_bits(khi: torch.Tensor, bits: int) -> torch.Tensor:
    return (khi.to(I64) & 0xFFFFFFFF) >> (32 - bits)


def index_find_device_split(hi: torch.Tensor, lo: torch.Tensor, bucket_starts: torch.Tensor,
                            bits: int, khi: torch.Tensor, klo: torch.Tensor,
                            iters: int = 18) -> torch.Tensor:
    """StrobemerIndex.find for a batch in 32-bit arithmetic (the JAX
    package's `index_find_device_split`, :265): the sorted hashes as
    (hi32, lo32) planes, a bucket-bounded binary search of `iters` steps
    (2**iters must cover the largest bucket) with lexicographic unsigned
    compares. hi, lo (n,) and the query planes khi, klo (any shape) are
    int32 tensors holding the uint32 bits; bucket_starts (2**bits + 1,)
    int64. Returns the first positions (int64, -1 when absent), equal to
    `index_find_device` with the bucket table's quirk."""
    n = hi.shape[0]
    his, los, qhi, qlo = (_ordered32(x) for x in (hi, lo, khi, klo))
    top = _top_bits(khi, bits)
    lo_b, hi_b = bucket_starts[top], bucket_starts[top + 1]
    a, b = lo_b, hi_b
    for _ in range(iters):
        mid = (a + b) >> 1
        safe = mid.clamp(max=n - 1)
        mh, ml = his[safe], los[safe]
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        act = a < b
        a, b = torch.where(act & less, mid + 1, a), torch.where(act & ~less, mid, b)
    pos = a
    in_range = (pos >= lo_b) & (pos < hi_b) & (pos < n)
    safe = torch.where(pos < n, pos, 0).clamp(max=n - 1)
    found = in_range & (hi[safe] == khi) & (lo[safe] == klo)
    return torch.where(found, pos, -1)


def index_find_device_gary(hi: torch.Tensor, lo: torch.Tensor, bucket_starts: torch.Tensor,
                           bits: int, khi: torch.Tensor, klo: torch.Tensor, iters: int,
                           G: int = 16) -> torch.Tensor:
    """StrobemerIndex.find for a batch by G-ary search (the JAX package's
    `index_find_device_gary`, :313): each of `iters` narrowing steps
    probes G - 1 strided positions at once and keeps the bracketing
    segment, then G contiguous entries decide the first one not below the
    query. hi, lo are the split planes (int32 with the uint32 bits)
    padded with at least G sentinel rows of 0xFFFFFFFF; n treats exactly
    G rows as padding (a larger pad stays correct, since a sentinel
    compares as +inf and the bucket bound excludes a false equality).
    `iters` from `gary_iters`. Returns the first positions (int64, -1 when
    absent), as `index_find_device_split`."""
    n = hi.shape[0] - G
    his, los = _ordered32(hi), _ordered32(lo)
    shape = khi.shape
    qhi, qlo = _ordered32(khi).reshape(-1, 1), _ordered32(klo).reshape(-1, 1)
    top = _top_bits(khi, bits).reshape(-1)
    lo_b, hi_b = bucket_starts[top], bucket_starts[top + 1]
    # invariant: the insertion point lies in [base, base + width]
    base, width = lo_b, hi_b - lo_b
    probe = torch.arange(1, G, device=hi.device)[None, :]
    imax = (1 << 31) - 1
    for _ in range(iters):
        stride = (width + (G - 1)) // G
        p = base[:, None] + probe * stride[:, None]
        safe = p.clamp(max=n - 1)
        oob = p >= n  # past the logical end: +inf
        vh = torch.where(oob, imax, his[safe])
        vl = torch.where(oob, imax, los[safe])
        less = (vh < qhi) | ((vh == qhi) & (vl < qlo))
        base = base + less.sum(1) * stride
        width = stride
    j = torch.arange(G, device=hi.device)[None, :]
    vh, vl = his[base[:, None] + j], los[base[:, None] + j]
    ge = (vh > qhi) | ((vh == qhi) & (vl >= qlo))
    pos = base + torch.where(ge & (j <= width[:, None]), j, width[:, None]).min(1).values
    in_range = (pos >= lo_b) & (pos < hi_b) & (pos < n)
    safe = torch.where(pos < n, pos, 0).clamp(max=n - 1)
    found = in_range & (hi[safe] == khi.reshape(-1)) & (lo[safe] == klo.reshape(-1))
    return torch.where(found, pos, -1).reshape(shape)
