"""Device NAM chaining: the reference's sweep-line merge of hits into NAMs
(`merge_hits_into_nams`, reference src/nam.cpp:370-536) over ordered hit
streams, many streams at once.

Counterparts of rabbitsalign_tpu/ops/chain_device.py, whose
`merge_hits_device` (:52) runs the merge as one `lax.scan` a stream. The
algorithm, on a fixed-capacity table of open NAMs per stream:

* the table is kept packed in insertion order (slots [0, n_open)), so
  "the first open NAM that the hit extends" is the lowest matching slot;
* a hit inside an open NAM's (query, ref) window, ending past both its
  ends or inside both, extends it; otherwise it opens a new NAM at slot
  n_open, and a full table sets the stream's overflow flag;
* once the hit's query start has advanced more than k past the last
  sweep, the NAMs that end before it are emitted and the survivors
  compacted stably;
* a segment boundary (the first hit of a new (ref_id, orientation)
  group) emits everything and resets the sweep, so one stream carries a
  read's groups back to back, and the stream's end emits what is open.

Emission order is observable (nam_id feeds later tie-breaks): a stream's
emissions go step-major, slot-minor. A step emits from the segment flush
or the sweep, never both (after a segment flush the table holds only the
new hit, which ends past its own start).

`merge_streams` is the batched entry: streams concatenated with offsets,
one kernel launch (csrc/merge_hits.cu, ops/chain_cuda.py) for all of
them, where the JAX front end launches one merge a read and orientation.
Its output is each stream's emissions, compacted: rows [step, slot, qs,
qe, rs, re, n_hits] from the stream's hit offset, a count and an overflow
flag. `merge_hits_device` keeps the JAX function's single-stream API and
dense outputs; `merge_stream_device_padded`, `iter_merged_nam_rows` and
`find_nams_device_chain` keep their meaning.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

I32 = torch.int32
EMIT_FIELDS = 7  # step, slot, qs, qe, rs, re, n_hits


def merge_hits_plain(hits: torch.Tensor, seg: torch.Tensor, offsets: torch.Tensor, k: int,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of csrc/merge_hits.cu: every stream merged in
    lock step, one hit index a step, the open-NAM tables (S, min(cap,
    longest stream)) tensors.

    hits (N, 4) int32 [qs, qe, rs, re], seg (N,) bool (the first hit of a
    group), offsets (S + 1,) int64 (stream s is hits[offsets[s]:
    offsets[s + 1]]). Returns (emissions (N, 7) int32: stream s's rows
    [step, slot, qs, qe, rs, re, n_hits] at offsets[s] onward, the end
    flush at step H_s; counts (S,) int32; overflow (S,) bool). A stream
    stops at the hit that finds its table full: its count holds the
    emissions before that hit, and nothing after is emitted. Rows past a
    stream's count are left as they were (zero)."""
    dev = hits.device
    S = offsets.numel() - 1
    N = hits.shape[0]
    out = torch.zeros((N, EMIT_FIELDS), dtype=I32, device=dev)
    if S <= 0:
        return out, torch.zeros(0, dtype=I32, device=dev), torch.zeros(0, dtype=torch.bool,
                                                                      device=dev)
    starts = offsets[:-1].to(torch.int64)
    H = (offsets[1:] - offsets[:-1]).to(torch.int64)
    Hmax = int(H.max())
    width = max(1, min(cap, Hmax))  # a stream never holds more NAMs open than it has hits
    slot = torch.arange(width, device=dev)[None, :]
    zeros = torch.zeros((S, width), dtype=torch.int64, device=dev)
    qs_t, qe_t, rs_t, re_t, qp_t, rp_t, nh_t = (zeros.clone() for _ in range(7))
    n_open = torch.zeros(S, dtype=torch.int64, device=dev)
    prev_q = torch.zeros(S, dtype=torch.int64, device=dev)
    n_out = torch.zeros(S, dtype=torch.int64, device=dev)
    ovf = torch.zeros(S, dtype=torch.bool, device=dev)

    def emit(mask: torch.Tensor, step: torch.Tensor) -> None:
        nonlocal n_out
        rank = torch.cumsum(mask.to(torch.int64), 1) - 1
        dst = (starts + n_out)[:, None] + rank
        row = torch.stack([step[:, None].expand(S, width), slot.expand(S, width), qs_t, qe_t,
                           rs_t, re_t, nh_t], 2)
        out[dst[mask]] = row[mask].to(I32)
        n_out = n_out + mask.sum(1)

    for j in range(Hmax + 1):
        live = ~ovf & (j <= H)
        if not bool(live.any()):
            break
        step = torch.full((S,), j, dtype=torch.int64, device=dev)
        idx = (starts + j).clamp(max=max(N - 1, 0))
        act = live & (j < H)
        x = hits[idx].to(torch.int64)
        qs, qe, rs, re = (x[:, f, None] for f in range(4))
        # the end of the stream: emit what is open
        done = live & (j == H)
        emit(done[:, None] & (slot < n_open[:, None]), step)
        # a segment boundary: emit everything, reset the sweep
        flush_all = act & seg[idx].to(torch.bool)
        emit(flush_all[:, None] & (slot < n_open[:, None]), step)
        n_open = torch.where(flush_all, 0, n_open)
        prev_q = torch.where(flush_all, 0, prev_q)
        alive = slot < n_open[:, None]
        in_win = alive & (qp_t < qs) & (qs <= qe_t) & (rp_t < rs) & (rs <= re_t)
        case_a = (qe > qe_t) & (re > re_t)
        case_b = (qe <= qe_t) & (re <= re_t)
        m = in_win & (case_a | case_b)
        any_m = act & m.any(1)
        hit_slot = any_m[:, None] & (slot == m.to(torch.int8).argmax(1)[:, None])
        grow = hit_slot & case_a
        qe_t = torch.where(grow, qe, qe_t)
        re_t = torch.where(grow, re, re_t)
        qp_t = torch.where(hit_slot, qs, qp_t)
        rp_t = torch.where(hit_slot, rs, rp_t)
        nh_t = torch.where(hit_slot, nh_t + 1, nh_t)
        # no match: open a NAM at slot n_open, or overflow and stop
        add = act & ~any_m
        full = add & (n_open >= cap)
        ovf = ovf | full
        add = add & ~full
        at = add[:, None] & (slot == n_open[:, None])
        qs_t, qe_t = torch.where(at, qs, qs_t), torch.where(at, qe, qe_t)
        rs_t, re_t = torch.where(at, rs, rs_t), torch.where(at, re, re_t)
        qp_t, rp_t = torch.where(at, qs, qp_t), torch.where(at, rs, rp_t)
        nh_t = torch.where(at, 1, nh_t)
        n_open = n_open + add.to(torch.int64)
        # the sweep: only once the query start advanced more than k
        sweep = act & ~full & (qs[:, 0] > prev_q + k)
        gone = sweep[:, None] & (slot < n_open[:, None]) & (qe_t < qs)
        emit(gone, step)
        perm = torch.argsort(gone.to(torch.int8), dim=1, stable=True)
        qs_t, qe_t, rs_t, re_t, qp_t, rp_t, nh_t = (
            t.gather(1, perm) for t in (qs_t, qe_t, rs_t, re_t, qp_t, rp_t, nh_t))
        n_open = n_open - gone.sum(1)
        prev_q = torch.where(sweep, qs[:, 0], prev_q)
    return out, n_out.to(I32), ovf


def merge_streams(hits: torch.Tensor, seg: torch.Tensor, offsets: torch.Tensor, k: int,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sweep-line merge of many hit streams in one launch: hits (N, 4)
    int32, seg (N,) bool, offsets (S + 1,) int64, all on one device.
    Returns (emissions (N, 7) int32, counts (S,) int32, overflow (S,)
    bool) as `merge_hits_plain` gives them, at any cap >= 1: CPU tensors
    take it, CUDA tensors launch csrc/merge_hits.cu once."""
    from .chain_cuda import merge_hits

    return merge_hits(hits, seg, offsets, k, cap)


def merge_hits_device(hits, seg_start, valid, k: int, cap: int):
    """One read's hit stream through the merge, with the JAX function's
    API (rabbitsalign_tpu/ops/chain_device.py:52): hits (H, 4) int32 rows
    [qs, qe, rs, re] in the host's processing order, seg_start (H,) bool,
    valid (H,) bool (invalid rows are no-ops), as tensors (their device
    is the merge's) or numpy arrays (the CPU).

    Returns (rows (H+1, cap, 5) int32, mask (H+1, cap) bool, overflow
    () bool): `rows[mask]` flattened in (step, slot) order gives the NAMs
    as [qs, qe, rs, re, n_hits] in emission order, the end-of-stream
    flush at step H. Where overflow is set, rows and mask are those
    emitted before the hit that overflowed (the JAX scan goes on past it;
    the caller uses neither)."""
    hits, seg_start, valid = (torch.as_tensor(a) for a in (hits, seg_start, valid))
    dev = hits.device
    H = hits.shape[0]
    keep = valid.to(torch.bool).nonzero().squeeze(1)
    stream = hits.to(I32)[keep].contiguous()
    seg = seg_start.to(torch.bool)[keep].contiguous()
    offsets = torch.tensor([0, keep.numel()], dtype=torch.int64, device=dev)
    emis, count, ovf = merge_streams(stream, seg, offsets, k, cap)
    emis = emis[:int(count[0])].to(torch.int64)
    step_of = torch.cat([keep, torch.tensor([H], device=dev)])  # the end flush at H
    rows = torch.zeros((H + 1, cap, 5), dtype=I32, device=dev)
    mask = torch.zeros((H + 1, cap), dtype=torch.bool, device=dev)
    at, sl = step_of[emis[:, 0]], emis[:, 1]
    rows[at, sl] = emis[:, 2:].to(I32)
    mask[at, sl] = True
    return rows, mask, ovf[0]


def merge_stream_device_padded(stream, seg, k: int, cap: int, device="cuda"):
    """An ordered hit stream (H rows [qs, qe, rs, re] and its seg flags)
    through `merge_hits_device` on `device`, padded to a power-of-two
    length of at least 16, as the JAX function pads it (there to reuse a
    compiled shape). Returns (rows, mask, H, Hp, overflow) with rows and
    mask as numpy; the end-of-stream flush row is at index Hp."""
    H = len(stream)
    Hp = 16
    while Hp < H:
        Hp *= 2
    hits = np.zeros((Hp, 4), dtype=np.int32)
    hits[:H] = np.asarray(stream, dtype=np.int32).reshape(H, 4)
    seg_p = np.zeros(Hp, dtype=bool)
    seg_p[:H] = seg
    valid = np.zeros(Hp, dtype=bool)
    valid[:H] = True
    rows, mask, ovf = merge_hits_device(
        *(torch.from_numpy(a).to(device) for a in (hits, seg_p, valid)), k, cap)
    return rows.cpu().numpy(), mask.cpu().numpy(), H, Hp, bool(ovf)


def iter_merged_nam_rows(rows, mask, seg, H: int, Hp: int) -> Iterator[Tuple[int, ...]]:
    """Yield (group_index, qs, qe, rs, re, n_hits) for every NAM row of a
    padded merge (`merge_stream_device_padded`), in flush order, by the
    attribution rule of `iter_emitted_nam_rows` (the end-of-stream flush
    is row Hp)."""
    emissions = [(min(s_i, H), c, *rows[s_i, c]) for s_i in list(range(H)) + [Hp]
                 for c in np.flatnonzero(mask[s_i])]
    return iter_emitted_nam_rows(np.asarray(emissions, dtype=np.int64).reshape(-1, 7),
                                 np.asarray(seg[:H], dtype=bool))


def iter_emitted_nam_rows(emissions: np.ndarray, seg: np.ndarray) -> Iterator[Tuple[int, ...]]:
    """Yield (group_index, qs, qe, rs, re, n_hits) for one stream's
    emissions (rows [step, slot, qs, qe, rs, re, n_hits], in order; the
    end flush at step H) and its seg flags (H,), by the attribution rule:
    a segment-boundary step's rows belong to the PRECEDING group; a sweep
    flush and the end-of-stream flush to the current group."""
    H = seg.shape[0]
    grp_of = np.cumsum(seg.astype(np.int64)) - 1
    steps = emissions[:, 0].astype(np.int64)
    inner = steps < H
    gi = np.full(steps.shape[0], int(grp_of[-1]) if H else -1, dtype=np.int64)
    gi[inner] = grp_of[steps[inner]] - seg[steps[inner]]
    for g, (qs, qe, rs, re, nh) in zip(gi.tolist(), emissions[:, 2:].tolist()):
        yield g, qs, qe, rs, re, nh


def stream_batch(streams: List[Tuple[List, List]], device) -> Optional[Tuple[torch.Tensor, ...]]:
    """Streams [(hits, seg flags)] as the merge's (hits, seg, offsets) on
    `device`, or None when there is no hit."""
    sizes = np.array([len(h) for h, _ in streams], dtype=np.int64)
    if not sizes.sum():
        return None
    hits = np.asarray([x for h, _ in streams for x in h], dtype=np.int32).reshape(-1, 4)
    seg = np.asarray([f for _, s in streams for f in s], dtype=bool)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return tuple(torch.from_numpy(a).to(device) for a in (hits, seg, offsets))


def _collect_hits(query_randstrobes, index):
    """find_nams' host hit collection (chain/nams.py): the lookups, the
    repetitive filter and each run's min-length-diff rule, per
    orientation. Returns (nonrepetitive fraction, hits_per_ref [fw, rc])."""
    from ..chain.nams import _add_to_hits_per_ref

    nq = len(query_randstrobes)
    positions = index.find(query_randstrobes.hash)
    found = positions >= 0
    total_hits = int(np.sum(found))
    filtered = np.zeros(nq, dtype=bool)
    if total_hits:
        filtered[found] = index.is_filtered(positions[found])
    hits_per_ref: List[dict] = [{}, {}]
    nr_good_hits = 0
    for i in np.flatnonzero(found & ~filtered):
        nr_good_hits += 1
        _add_to_hits_per_ref(hits_per_ref[bool(query_randstrobes.is_reverse[i])],
                             int(query_randstrobes.start[i]), int(query_randstrobes.end[i]),
                             index, int(positions[i]))
    # the reference's float32 ratio (nam.cpp:753)
    nonrep = (float(np.float32(nr_good_hits) / np.float32(total_hits))
              if total_hits > 0 else 1.0)
    return nonrep, hits_per_ref


def ordered_stream(groups: dict) -> Tuple[List[Tuple[int, ...]], List[bool], List[int]]:
    """One orientation's groups {ref_id: [hits]} as the merge's input: the
    groups in robin_hood iteration order, each group's hits introsorted by
    (query start, ref start) (the reference's exact order, ties
    included). Returns (stream, seg flags, the ref_id of each group)."""
    from ..chain.nams import _rh_items
    from ..utils.sorting import introsort

    stream: List[Tuple[int, ...]] = []
    seg: List[bool] = []
    ref_ids: List[int] = []
    for ref_id, hits in _rh_items(groups):
        hits = list(hits)
        introsort(hits, [(h[0] << 32) | h[2] for h in hits], False)
        stream.extend(hits)
        seg.extend(j == 0 for j in range(len(hits)))
        ref_ids.append(ref_id)
    return stream, seg, ref_ids


def find_nams_device_chain(query_randstrobes, index, cap: int = 32, device="cuda"):
    """find_nams (reference src/nam.cpp:771-926) with the sweep-line merge
    on `device`: the host's hit collection and ordering (chain/nams.py),
    then both orientations' streams merged in one `merge_streams` launch,
    and the NAMs rebuilt in emission order. Returns
    (nonrepetitive_fraction, List[Nam]) as chain/nams.find_nams does; a
    read whose open-NAM table overflows is chained by the host
    `find_nams`, as in the JAX function (:211)."""
    from ..chain.nams import Nam, _nam_score, find_nams

    if len(query_randstrobes) == 0:
        return 1.0, []
    nonrep, hits_per_ref = _collect_hits(query_randstrobes, index)
    parts = [ordered_stream(hits_per_ref[rc]) + (rc,) for rc in (0, 1)]
    parts = [p for p in parts if p[0]]
    if not parts:
        return nonrep, []
    batch = stream_batch([p[:2] for p in parts], device)
    emis, counts, ovf = (x.cpu().numpy() for x in merge_streams(*batch, index.k(), cap))
    if ovf.any():
        return find_nams(query_randstrobes, index)  # the host path, as in JAX
    nams: List = []
    for (_, seg, ref_ids, rc), at, count in zip(parts, batch[2].tolist(), counts):
        for gi, qs, qe, rs, re, nh in iter_emitted_nam_rows(emis[at:at + count],
                                                            np.asarray(seg)):
            nam = Nam(nam_id=len(nams), query_start=qs, query_end=qe, ref_start=rs,
                      ref_end=re, n_hits=nh, ref_id=ref_ids[gi], is_rc=bool(rc))
            nam.score = _nam_score(nam)
            nams.append(nam)
    return nonrep, nams
