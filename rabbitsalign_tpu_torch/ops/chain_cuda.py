"""The device NAM front end's kernels: the sweep-line merge
(csrc/merge_hits.cu) and the run walk with its keep rule
(csrc/walk_hits.cu), behind wrappers that take their plain PyTorch
versions (ops/chain_device.py `merge_hits_plain`, ops/front_device.py
`walk_hits_plain`) for CPU tensors and launch the kernel, or raise, for
CUDA tensors.

Neither replaces a Pallas kernel: in rabbitsalign_tpu they are XLA ops,
`merge_hits_device` (ops/chain_device.py:52) and the run walk, keep rule
and compaction of `seed_find_walk` (ops/front_device.py:80-145). Each
kernel's output equals its plain version's byte for byte.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from .chain_device import EMIT_FIELDS, merge_hits_plain
from .front_device import walk_hits_compact_plain, walk_hits_plain, walk_views, walk_words

# launches of the merge kernel by merge_hits and of the walk kernel by
# walk_hits; plain-version calls and empty batches are not counted
launches_merge = 0
launches_walk = 0
_count_lock = threading.Lock()


def _kernels(x: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    from .cuda_build import load_kernels

    return load_kernels()


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def merge_hits(hits: torch.Tensor, seg: torch.Tensor, offsets: torch.Tensor, k: int,
               cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sweep-line merge of S hit streams: hits (N, 4) int32 [qs, qe,
    rs, re], seg (N,) bool, offsets (S + 1,) int64, on one device, at
    most `cap` (any cap >= 1) NAMs open a stream. Returns (emissions (N,
    7) int32 [step, slot, qs, qe, rs, re, n_hits] from each stream's
    offset, zero past its count; counts (S,) int32; overflow (S,) bool),
    as `chain_device.merge_hits_plain`. CPU tensors take that plain
    version; CUDA tensors launch the kernel once: a lane a stream, the
    warp for a stream with more than 32 NAMs open (the table in a
    scratch past 128)."""
    global launches_merge
    if hits.dim() != 2 or hits.shape[1] != 4 or hits.dtype != torch.int32:
        raise ValueError(f"hits must be (N, 4) int32, got {tuple(hits.shape)} {hits.dtype}")
    if seg.shape != hits.shape[:1] or seg.dtype != torch.bool:
        raise ValueError("seg must be (N,) bool")
    if offsets.dim() != 1 or offsets.numel() < 1 or offsets.dtype != torch.int64:
        raise ValueError("offsets must be (S + 1,) int64")
    if not (seg.device == offsets.device == hits.device):
        raise ValueError("hits, seg and offsets must be on one device")
    if cap < 1:
        raise ValueError(f"merge_hits: cap {cap} < 1")
    if hits.device.type == "cpu":
        return merge_hits_plain(hits, seg, offsets, k, cap)
    lib = _kernels(hits, "merge_hits")
    hits, seg, offsets = hits.contiguous(), seg.contiguous(), offsets.contiguous()
    S, N, dev = offsets.numel() - 1, hits.shape[0], hits.device
    # the kernel writes every element
    out = torch.empty((N, EMIT_FIELDS), dtype=torch.int32, device=dev)
    counts = torch.empty(S, dtype=torch.int32, device=dev)
    overflow = torch.empty(S, dtype=torch.bool, device=dev)
    scratch = torch.empty((N, EMIT_FIELDS), dtype=torch.int32, device=dev) if cap > 128 else None
    if S == 0 and N == 0:
        return out, counts, overflow
    with torch.cuda.device(dev):
        err = lib.merge_hits_launch(hits.data_ptr(), seg.data_ptr(), offsets.data_ptr(), S, N, k,
                                    cap, out.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
                                    None if scratch is None else scratch.data_ptr(), _stream(hits))
    _check_launch(err, "merge_hits")
    with _count_lock:
        launches_merge += 1
    return out, counts, overflow


def _walk_args(args, cap: int, cutoff: int) -> int:
    """Checks `walk_hits`' tensors, cap and cutoff; returns the index's rows."""
    want = (torch.int32, torch.int64, torch.int64, torch.int32, torch.int32, torch.uint8,
            torch.int64, torch.int64, torch.int32, torch.int32)
    counts = args[0]
    for x, dt in zip(args, want):
        if x.dtype != dt or x.dim() != 1 or x.device != counts.device:
            raise ValueError(f"walk_hits: 1-D tensors of {want} on one device expected")
    idx_hashes, idx_pos, idx_packed = args[7:]
    n = idx_hashes.numel()
    if idx_pos.numel() < n or idx_packed.numel() < n or args[1].numel() != counts.numel():
        raise ValueError("walk_hits: the index planes are shorter than its hashes, or the "
                         "offsets do not match the counts")
    if cap < 0 or cutoff < 0:
        raise ValueError(f"walk_hits: cap {cap}, cutoff {cutoff}")
    return n


def _launch_walk(args, n: int, k: int, cutoff: int, maxh: int, cap: int, outs) -> None:
    """One launch of the walk kernel on `args`' card into `outs` (hits,
    n_hits, total, good, overflow)."""
    global launches_walk
    counts = args[0]
    lib = _kernels(counts, "walk_hits")
    args = tuple(x.contiguous() for x in args)
    with torch.cuda.device(counts.device):
        err = lib.walk_hits_launch(*(x.data_ptr() for x in args[:7]), counts.numel(),
                                   *(x.data_ptr() for x in args[7:]), n, k, cutoff, maxh, cap,
                                   *(x.data_ptr() for x in outs), _stream(counts))
    _check_launch(err, "walk_hits")
    with _count_lock:
        launches_walk += 1


def walk_hits(counts: torch.Tensor, offsets: torch.Tensor, hashes: torch.Tensor,
              starts: torch.Tensor, ends: torch.Tensor, is_rev: torch.Tensor,
              positions: torch.Tensor, idx_hashes: torch.Tensor, idx_pos: torch.Tensor,
              idx_packed: torch.Tensor, k: int, cutoff: int, maxh: int, cap: int
              ) -> Tuple[torch.Tensor, ...]:
    """The run walk of N reads' strobes (the seeding buffer's arrays,
    `seed_device.strobe_views`, with the lookup's positions) against the
    index (idx_hashes (n,) int64 with the uint64 bits; idx_pos and
    idx_packed int32 with the uint32 bits, at least n rows): the
    repetitive filter at `cutoff`, at most `cap` rows a run, the
    min-length-diff keep rule and the kept hits compacted. Returns (hits
    (N, maxh, 6) int32 [is_rc, ref_id, qs, qe, rs, re], n_hits, total,
    good (N,) int32, overflow (N,) bool), as `front_device.walk_hits_plain`.
    CPU tensors take that plain version; CUDA tensors launch the kernel, a
    warp a read and a lane a strobe (the warp for runs past a few rows).
    `walk_hits_compact` is the layout of the main path."""
    args = (counts, offsets, hashes, starts, ends, is_rev, positions, idx_hashes, idx_pos,
            idx_packed)
    n = _walk_args(args, cap, cutoff)
    if maxh < 1:
        raise ValueError(f"walk_hits: maxh {maxh}")
    if counts.device.type == "cpu":
        return walk_hits_plain(*args, k, cutoff, maxh, cap)
    N = counts.numel()
    dev = counts.device
    hits = torch.empty((N, maxh, 6), dtype=torch.int32, device=dev)  # the kernel zeroes
    n_hits, total, good = (torch.empty(N, dtype=torch.int32, device=dev) for _ in range(3))
    overflow = torch.empty(N, dtype=torch.uint8, device=dev)
    if N:
        _launch_walk(args, n, k, cutoff, maxh, cap, (hits, n_hits, total, good, overflow))
    return hits, n_hits, total, good, overflow.bool()


def walk_hits_compact(counts: torch.Tensor, offsets: torch.Tensor, hashes: torch.Tensor,
                      starts: torch.Tensor, ends: torch.Tensor, is_rev: torch.Tensor,
                      positions: torch.Tensor, idx_hashes: torch.Tensor, idx_pos: torch.Tensor,
                      idx_packed: torch.Tensor, k: int, cutoff: int, cap: int) -> torch.Tensor:
    """`walk_hits` at maxh 0 into one int32 buffer of
    `front_device.walk_words(N, T)` words, whose `walk_views` are the
    hits (T, 6), n_hits, total, good and overflow (uint8): a chunk's walk
    comes to the host in one copy. CPU tensors take
    `front_device.walk_hits_compact_plain`; CUDA tensors launch the
    kernel once."""
    args = (counts, offsets, hashes, starts, ends, is_rev, positions, idx_hashes, idx_pos,
            idx_packed)
    n = _walk_args(args, cap, cutoff)
    if counts.device.type == "cpu":
        return walk_hits_compact_plain(*args, k, cutoff, cap)
    N, T = counts.numel(), hashes.numel()
    buf = torch.empty(walk_words(N, T), dtype=torch.int32, device=counts.device)
    if N:
        _launch_walk(args, n, k, cutoff, 0, cap, walk_views(buf, N, T))
    return buf
