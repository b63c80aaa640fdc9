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
