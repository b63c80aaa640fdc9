"""The composed device NAM front end: seeding, index lookup, run walk and
hit compaction on the device for a read batch, feeding the device
sweep-line merge, as a complete `find_nams` twin that never reads the
host's index arrays.

Counterparts of rabbitsalign_tpu/ops/front_device.py. `seed_find_walk`
(:53) there is one jit of XLA ops; here it is three kernels on the
device's stream: the seeding kernel (csrc/seed_randstrobes.cu, both
strands' randstrobes of each read, compacted, in `strobe_views`' layout;
a tie row, whose window minima the closed form cannot order, gets no
strobes and count -1), the lookup (csrc/index_find.cu, which equals the
JAX function's G-ary lookup `index_find_device_gary` by definition), and
the run walk (csrc/walk_hits.cu: the repetitive filter, the equal-hash
run walk with the min-length-diff keep rule of the reference's
add_to_hits_per_ref, reference src/nam.cpp:68-85, and the kept hits
compacted). `find_nams_composed_batch` then orders the downloaded hits on
the host (robin_hood group order, introsort tie order: functions of the
hit values, no index access), merges every read's streams in one launch
(ops/chain_device.py `merge_streams`) and rebuilds the NAMs. The
reference's equivalent is the fused CPU loop randstrobes_query ->
find_nams (reference src/nam.cpp:771-926). No mapping path runs it.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .seed_device import I64, INT32_MAX, gary_iters, split_hash_u64, strobe_views

# sentinel rows after the uploaded split planes, as the JAX upload pads
# them, so that the G-ary lookup's final slices stay inside the planes
PAD = 1024
LOOKUP_G = 16


def walk_hits_plain(counts: torch.Tensor, offsets: torch.Tensor, hashes: torch.Tensor,
                    starts: torch.Tensor, ends: torch.Tensor, is_rev: torch.Tensor,
                    positions: torch.Tensor, idx_hashes: torch.Tensor, idx_pos: torch.Tensor,
                    idx_packed: torch.Tensor, k: int, cutoff: int, maxh: int, cap: int):
    """The plain version of csrc/walk_hits.cu (ops/chain_cuda.py
    `walk_hits`, which documents the arguments): the walked strobes' runs
    read one row index a step for all of them, the keep rule against each
    run's least diff so far, the kept hits ordered strobe-major and
    run-minor and written, as many of each read's as its room holds, into
    zeros. The room is row b of hits (N, maxh, 6), or where maxh is 0 the
    read's strobe count of rows at its strobe offset in hits (T, 6)."""
    dev = counts.device
    N = counts.numel()
    n = idx_hashes.numel()
    T = hashes.numel()
    room = counts.clamp(min=0).to(I64) if maxh == 0 else torch.full((N,), maxh, device=dev)
    hits = torch.zeros((T, 6) if maxh == 0 else (N, maxh, 6), dtype=torch.int32, device=dev)
    read = torch.repeat_interleave(torch.arange(N, device=dev), counts.clamp(min=0).to(I64),
                                   output_size=T)
    found = positions >= 0
    p = torch.where(found, positions, 0)
    pc = p + cutoff
    # a probe past the index reads 2**64 - 1 (int64 bits -1), as the host's hash_at
    probe = torch.where(pc < n, idx_hashes[pc.clamp(max=max(n - 1, 0))], -1)
    walk = found & (probe != hashes)
    total = torch.zeros(N, dtype=I64, device=dev).index_add_(0, read, found.to(I64))
    good = torch.zeros(N, dtype=I64, device=dev).index_add_(0, read, walk.to(I64))

    # the runs, a row index a step: (strobe, row, rs, re, ref_id) kept
    act = walk.nonzero().squeeze(1)
    carry = torch.full((act.numel(),), INT32_MAX, dtype=I64, device=dev)
    qspan = (ends - starts).to(I64)
    kept = []
    for j in range(cap):
        q = p[act] + j
        ok = (q < n) & (idx_hashes[q.clamp(max=max(n - 1, 0))] == hashes[act])
        act, q, carry = act[ok], q[ok], carry[ok]
        if act.numel() == 0:
            break
        rs = idx_pos[q].to(I64) & 0xFFFFFFFF
        pk = idx_packed[q].to(I64) & 0xFFFFFFFF
        re = rs + (pk & 0xFF) + k
        diff = (qspan[act] - (re - rs)).abs()
        keep = diff <= carry
        carry = torch.minimum(carry, diff)
        kept.append((act[keep], torch.full_like(act[keep], j), rs[keep], re[keep],
                     pk[keep] >> 8))
    n_kept = torch.zeros(N, dtype=I64, device=dev)
    if kept:
        strobe, row, rs, re, rid = (torch.cat(c) for c in zip(*kept))
        order = torch.argsort(strobe * max(cap, 1) + row)
        strobe, rs, re, rid = strobe[order], rs[order], re[order], rid[order]
        r = read[strobe]
        n_kept.index_add_(0, r, torch.ones_like(r))
        first = torch.cumsum(n_kept, 0) - n_kept  # each read's first kept hit
        rank = torch.arange(r.numel(), device=dev) - first[r]
        sel = rank < room[r]
        vals = torch.stack([is_rev[strobe].to(I64), rid, starts[strobe].to(I64),
                            ends[strobe].to(I64), rs, re], 1)[sel].to(torch.int32)
        if maxh == 0:
            hits[offsets[r[sel]] + rank[sel]] = vals
        else:
            hits[r[sel], rank[sel]] = vals
    return (hits, torch.minimum(n_kept, room).to(torch.int32), total.to(torch.int32),
            good.to(torch.int32), n_kept > room)


def walk_words(n_reads: int, n_strobes: int) -> int:
    """int32 words of the compact walk buffer (`walk_views`)."""
    return 6 * n_strobes + 3 * n_reads + (n_reads + 3) // 4


def walk_views(buf: torch.Tensor, n_reads: int, n_strobes: int) -> Tuple[torch.Tensor, ...]:
    """The arrays of a compact walk buffer (int32, `walk_words` long, on
    any device; ops/chain_cuda.py `walk_hits_compact`): (hits (T, 6)
    int32, each read's room its strobe count of rows at its strobe
    offset; n_hits, total, good (N,) int32; overflow (N,) uint8), views
    into `buf`, so that one copy brings a chunk's walk to the host."""
    T, N = n_strobes, n_reads
    return (buf[:6 * T].view(T, 6), buf[6 * T:6 * T + N], buf[6 * T + N:6 * T + 2 * N],
            buf[6 * T + 2 * N:6 * T + 3 * N], buf[6 * T + 3 * N:].view(torch.uint8)[:N])


def walk_hits_compact_plain(*args) -> torch.Tensor:
    """The plain version of `chain_cuda.walk_hits_compact` (the same
    arguments): `walk_hits_plain` at maxh 0, packed into one buffer."""
    *arrays, k, cutoff, cap = args
    hits, n_hits, total, good, overflow = walk_hits_plain(*arrays, k, cutoff, 0, cap)
    N, T = n_hits.numel(), hits.shape[0]
    buf = torch.zeros(walk_words(N, T), dtype=torch.int32, device=hits.device)
    views = walk_views(buf, N, T)
    for view, x in zip(views, (hits, n_hits, total, good, overflow.to(torch.uint8))):
        view.copy_(x)
    return buf


def seed_find_walk(codes, lengths, idx_hi, idx_lo, idx_pos, idx_packed, bucket_starts,
                   k: int, s: int, t: int, w_min: int, w_max: int, q: int, max_dist: int,
                   M: int, bits: int, cutoff: int, maxh: int, cap: int, iters: int,
                   idx_hashes: Optional[torch.Tensor] = None):
    """The device front end for a (B, L) read batch, with the JAX
    function's arguments and outputs (rabbitsalign_tpu/ops/front_device.py
    :53): codes (B, L) uint8, lengths (B,) int32 (>= 0); the index as
    `upload_index_split` gives it (split planes padded with PAD sentinel
    rows, run records, the bucket table); cutoff the filter cutoff; cap
    the run walk's rows (cap >= cutoff covers every unfiltered run);
    iters the G-ary lookup's steps, which the lookup here does not need.
    `idx_hashes` is the u64 hash plane (int64 bits, n rows) that the
    lookup and the walk read; without it, it is built from the split
    planes.

    Three kernels on the tensors' device (plain versions on the CPU):
    `seed_cuda.seed_randstrobes`, `seed_cuda.index_find` and
    `chain_cuda.walk_hits`. Returns (hits (B, maxh, 6) int32 rows [is_rc,
    ref_id, qs, qe, rs, re] in the host's processing order, n_hits (B,),
    total (B,), good (B,) int32, tie (B,) bool, overflow (B,) bool). A
    tie row (or one of more than M syncmers) has no strobes here and
    must take the host path: its hits, total and good are 0 (the JAX
    function seeds it in closed form all the same)."""
    from .chain_cuda import walk_hits
    from .seed_cuda import index_find, seed_randstrobes

    if idx_hashes is None:
        n = idx_hi.shape[0] - PAD
        idx_hashes = ((idx_hi[:n].to(I64) & 0xFFFFFFFF) << 32) | (idx_lo[:n].to(I64)
                                                                  & 0xFFFFFFFF)
    B = codes.shape[0]
    buf, total = seed_randstrobes(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M)
    counts, offsets, hashes, starts, ends, is_rev, positions = strobe_views(buf, B, total)
    index_find(idx_hashes, bucket_starts, bits, hashes, out=positions)
    hits, n_hits, n_total, good, overflow = walk_hits(
        counts, offsets, hashes, starts, ends, is_rev, positions, idx_hashes, idx_pos,
        idx_packed, k, cutoff, maxh, cap)
    return hits, n_hits, n_total, good, counts < 0, overflow


# the JAX front end's code table: A, C, G, T in either case, all else 4
# (utils/dna.py's SEQ_NT4 also reads U as T)
NT4 = np.full(256, 4, dtype=np.uint8)
for _ch, _code in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    NT4[_ch] = _code


def front_hits(seqs: List[bytes], index_dev, params, filter_cutoff: int, L: int = 256,
               maxh: int = 192, cap: int = 0) -> dict:
    """The device part of `find_nams_composed_batch`: the reads coded into
    a (B, L) batch (a read longer than L marked for the host path), one
    `seed_find_walk` on the index's device, its outputs copied back.
    Returns numpy arrays: lens (B,) (-1 for a long read), hits (B, m, 6)
    (m the most hits a read has), n_hits, total, good, tie and overflow
    (B,)."""
    idx_hi, idx_lo, idx_pos, idx_packed, bucket_starts, bits, iters, idx_hashes = index_dev
    dev = idx_hi.device
    sp, rp = params.syncmer, params.randstrobe
    B = len(seqs)
    codes = np.full((B, L), 4, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, sq in enumerate(seqs):
        if len(sq) > L:
            lens[i] = -1  # the host path
            continue
        codes[i, :len(sq)] = NT4[np.frombuffer(sq, dtype=np.uint8)]
        lens[i] = len(sq)
    hits, n_hits, total, good, tie, overflow = seed_find_walk(
        torch.from_numpy(codes).to(dev), torch.from_numpy(np.maximum(lens, 0)).to(dev),
        idx_hi, idx_lo, idx_pos, idx_packed, bucket_starts, sp.k, sp.s, sp.t_syncmer,
        rp.w_min, rp.w_max, rp.q, rp.max_dist, L, int(bits), int(filter_cutoff), maxh,
        cap or filter_cutoff, int(iters), idx_hashes=idx_hashes)
    out = {name: x.cpu().numpy() for name, x in (("n_hits", n_hits), ("total", total),
                                                  ("good", good), ("tie", tie),
                                                  ("overflow", overflow))}
    # only the rows that hold hits come back
    out["hits"] = hits[:, :int(out["n_hits"].max(initial=0))].cpu().numpy()
    out["lens"] = lens
    return out


def hit_streams(front: dict):
    """The host ordering of `find_nams_composed_batch`: for each read the
    front end does not flag, each orientation's hits grouped by ref_id in
    first-touch order, then `chain_device.ordered_stream` (robin_hood
    group order, introsort within a group). Returns (streams [(hits, seg
    flags)], metas [(read, is_rc, ref_ids)]), reads in order, forward
    before reverse."""
    from .chain_device import ordered_stream

    bad = (front["lens"] < 0) | front["tie"] | front["overflow"]
    streams, metas = [], []
    for b in np.flatnonzero(~bad & (front["n_hits"] > 0)):
        rows = front["hits"][b, :front["n_hits"][b]].tolist()
        for rc in (0, 1):
            groups: dict = {}
            for r in rows:
                if r[0] == rc:
                    groups.setdefault(r[1], []).append((r[2], r[3], r[4], r[5]))
            if groups:
                stream, seg, ref_ids = ordered_stream(groups)
                streams.append((stream, seg))
                metas.append((int(b), rc, ref_ids))
    return streams, metas


def find_nams_composed_batch(seqs: List[bytes], index_dev, params, filter_cutoff: int,
                             L: int = 256, maxh: int = 192, cap: int = 0, merge_cap: int = 32,
                             stats: Optional[dict] = None):
    """A batched `find_nams` twin over the composed device front end: one
    `seed_find_walk` for the batch (`front_hits`), the host's ordering of
    the downloaded hits (`hit_streams`: no index arrays read), one
    `merge_streams` launch for every read's orientation streams, and the
    NAMs rebuilt in emission order. Returns a list of
    (nonrepetitive_fraction, List[Nam]), or None for a read that needs the
    host path (longer than L, a seeding tie, more than maxh hits, or an
    open-NAM table overflow), as the JAX function
    (rabbitsalign_tpu/ops/front_device.py:148).

    index_dev: `upload_index_split(index, device)`; the work runs on its
    device. `stats`, when given, receives the seconds of the four parts,
    "front" (the device front end with its copy back), "order" (the host
    ordering), "merge" (the merge with its copy back) and "attribute"
    (the NAMs rebuilt), and the reads sent to the host path: "long",
    "tie", "hit_overflow" and "merge_overflow"."""
    from ..chain.nams import Nam, _nam_score
    from .chain_device import iter_emitted_nam_rows, merge_streams, stream_batch

    t0 = time.perf_counter()
    front = front_hits(seqs, index_dev, params, filter_cutoff, L, maxh, cap)
    t1 = time.perf_counter()
    streams, metas = hit_streams(front)
    t2 = time.perf_counter()
    batch = stream_batch(streams, index_dev[0].device)
    if batch is not None:
        emis, counts, ovf = (x.cpu().numpy() for x in merge_streams(*batch, params.syncmer.k,
                                                                     merge_cap))
        stream_at = batch[2].cpu().numpy()
    t3 = time.perf_counter()

    long, tie, hit_ovf = front["lens"] < 0, front["tie"], front["overflow"]
    total, good = front["total"], front["good"]
    out = [None if long[b] or tie[b] or hit_ovf[b] else
           (float(np.float32(good[b]) / np.float32(total[b])) if total[b] > 0 else 1.0, [])
           for b in range(len(seqs))]
    merge_ovf = set()
    for j, ((_, seg), (b, rc, ref_ids)) in enumerate(zip(streams, metas)):
        if ovf[j]:
            merge_ovf.add(b)
        if b in merge_ovf:
            out[b] = None
            continue
        nams = out[b][1]
        at = int(stream_at[j])
        for gi, qs, qe, rs, re, nh in iter_emitted_nam_rows(emis[at:at + counts[j]],
                                                            np.asarray(seg)):
            nam = Nam(nam_id=len(nams), query_start=qs, query_end=qe, ref_start=rs, ref_end=re,
                      n_hits=nh, ref_id=ref_ids[gi], is_rc=bool(rc))
            nam.score = _nam_score(nam)
            nams.append(nam)
    if stats is not None:
        stats.update(front=t1 - t0, order=t2 - t1, merge=t3 - t2,
                     attribute=time.perf_counter() - t3, long=int(long.sum()),
                     tie=int((tie & ~long).sum()), hit_overflow=int((hit_ovf & ~tie).sum()),
                     merge_overflow=len(merge_ovf))
    return out


def upload_index_split(index, device="cuda"):
    """The index on `device` for the composed front end: (hi, lo, pos,
    packed, bucket_starts, bits, iters, hashes). hi and lo are the split
    hash planes and pos and packed the run records, int32 tensors with
    the uint32 bits, each padded with PAD sentinel rows (0xFFFFFFFF
    hashes, zero records) as in the JAX upload; bucket_starts the bucket
    table (int64); iters the G-ary lookup's depth for this index's
    buckets; hashes the u64 plane (int64 bits, unpadded) that the lookup
    kernel and the walk read. Requires n < 2^31 entries and positions
    below 2^31 (the hit rows carry genome positions as int32)."""
    n = index.hashes.shape[0]
    if n >= (1 << 31):  # a deployment guard, as in the JAX upload
        raise ValueError("split lookup needs n < 2^31 entries per shard")
    if n and int(index.positions.max()) >= (1 << 31):
        raise ValueError("composed front end needs genome positions < 2^31; "
                         "shard the index (--shard-index) for larger genomes")
    hi, lo = split_hash_u64(index.hashes)

    def put(a, fill=None):
        a = np.ascontiguousarray(a)
        if fill is not None:
            a = np.concatenate([a, np.full(PAD, fill, a.dtype)])
        if a.dtype in (np.uint32, np.uint64):
            a = a.view(np.int32 if a.dtype == np.uint32 else np.int64)
        return torch.from_numpy(a).to(device)

    return (put(hi, 0xFFFFFFFF), put(lo, 0xFFFFFFFF), put(index.positions, 0),
            put(index.packed, 0), put(index.randstrobe_start_indices), int(index.bits),
            gary_iters(index.randstrobe_start_indices, LOOKUP_G), put(index.hashes))
