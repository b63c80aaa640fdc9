"""The device seeding kernels of ``--device-seed``: randstrobe seeding
(csrc/seed_randstrobes.cu) and the index lookup (csrc/index_find.cu),
and the exact scan seeder's syncmers (csrc/syncmers_scan.cu), behind
wrappers that take their plain PyTorch versions (ops/seed_device.py) for
CPU tensors and launch the kernel, or raise, for CUDA tensors.

None replaces a Pallas kernel: in rabbitsalign_tpu they are XLA ops,
`randstrobes_query_vec` (ops/seed_device.py:432) with the compaction of
`seed_and_find` (:555), `index_find_device` (:239) and `syncmers_device`
(:58). Each kernel's output equals its plain version's byte for byte.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .seed_device import (index_find_device, seed_strobes_plain, strobe_bytes, strobes_at,
                          syncmers_scan_plain)

MAX_L = 512  # codes per read, and slots per strand, the seeding kernel takes

# launches of the seeding kernel by seed_randstrobes, of the lookup
# kernel by index_find and of the scan seeder by syncmers_scan;
# plain-version calls and empty batches (nothing to launch) are not
# counted. Mapping workers launch from several threads, so updates hold
# _count_lock.
launches_seed = 0
launches_find = 0
launches_syncmers = 0
_count_lock = threading.Lock()


def _kernels(x: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    from .cuda_build import load_kernels

    return load_kernels()


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")


def seed_buffer(n_reads: int, M: int, device) -> torch.Tensor:
    """One uint8 allocation for the seeding kernel: the arrays of
    `seed_device.strobe_views` with room for n_reads * 2M strobes, then
    the kernel's scratch: (n_reads, M) syncmer lists (hashes int64,
    positions int32) and the offsets of its tiles of reads (int64)."""
    return torch.empty(_tiles_at(n_reads, M) + 8 * (n_reads + 1), dtype=torch.uint8,
                       device=device)


def _scratch_at(n_reads: int, M: int) -> int:
    return strobe_bytes(n_reads, 2 * M * n_reads) + 7 & ~7


def _tiles_at(n_reads: int, M: int) -> int:
    return _scratch_at(n_reads, M) + 12 * n_reads * M + 7 & ~7


def launch_seed_randstrobes(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                            w_min: int, w_max: int, q: int, max_dist: int, M: int,
                            buf: torch.Tensor) -> None:
    """Queue the seeding kernel on the current stream, writing into `buf`
    (from `seed_buffer`); checked CUDA tensors of `seed_randstrobes`.
    Counts no launch and reads nothing back."""
    lib = _kernels(codes, "seed_randstrobes")
    N, L = codes.shape
    at = strobes_at(N)
    scratch = _scratch_at(N, M)
    ptr = buf.data_ptr()
    with torch.cuda.device(codes.device):
        err = lib.seed_randstrobes_launch(
            codes.data_ptr(), lengths.data_ptr(), N, L, k, s, t, w_min, w_max,
            ctypes.c_uint64(q & ((1 << 64) - 1)), max_dist, M, ptr + 8,
            ptr + at - 8 * N, ptr, ptr + at, ptr + scratch + 8 * N * M, ptr + scratch,
            ptr + _tiles_at(N, M), torch.cuda.current_stream(codes.device).cuda_stream)
    _check_launch(err, "seed_randstrobes")


def seed_randstrobes(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                     w_min: int, w_max: int, q: int, max_dist: int, M: int
                     ) -> Tuple[torch.Tensor, int]:
    """codes (N, L) uint8 {0..3, 4 = N}, lengths (N,) int32 (-1: longer
    than L) -> (buffer, total): both strands' randstrobes of every read,
    compacted, in a uint8 buffer whose arrays `seed_device.strobe_views`
    gives (counts, offsets, and `total` strobes' hashes, starts, ends,
    is_rev; the positions left to the lookup), as
    `seed_device.seed_strobes_plain`. CPU tensors take that plain
    version; CUDA tensors launch the kernel (L and M at most MAX_L) into
    one allocation sized for N * 2M strobes and read the total back, the
    one host sync."""
    global launches_seed
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be (B, L) uint8, got {tuple(codes.shape)} {codes.dtype}")
    B, L = codes.shape
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must be on one device")
    if not (1 <= s <= k <= 32 and 1 <= t <= k - s + 1 and 0 <= w_min <= w_max and M >= 1):
        raise ValueError(f"unsupported seeding parameters k={k} s={s} t={t} "
                         f"w_min={w_min} w_max={w_max} M={M}")
    if codes.device.type == "cpu":
        return seed_strobes_plain(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M)
    _kernels(codes, "seed_randstrobes")
    if L > MAX_L or M > MAX_L:
        raise ValueError(f"seed_randstrobes: the kernel takes L and M up to {MAX_L}, "
                         f"not {L} and {M}")
    buf = seed_buffer(B, M, codes.device)
    if B == 0:
        buf[:8].zero_()
        return buf, 0
    launch_seed_randstrobes(codes.contiguous(), lengths.contiguous(), k, s, t, w_min, w_max, q,
                            max_dist, M, buf)
    with _count_lock:
        launches_seed += 1
    return buf, int(buf[:8].view(torch.int64)[0])


def index_find(index_hashes: torch.Tensor, bucket_starts: torch.Tensor, bits: int,
               queries: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first position of each query's hash in the sorted index, or -1,
    with the bucket table's quirk, as `seed_device.index_find_device`.
    index_hashes (n,), bucket_starts (2**bits + 1,) and queries (any
    shape) int64 with uint64 bits, on one device; written into `out`
    (int64, the queries' shape) when given, else a new tensor. CPU tensors
    take the plain version; CUDA tensors launch the kernel, one thread a
    query."""
    global launches_find
    for x in (index_hashes, bucket_starts, queries):
        if x.dtype != torch.int64 or x.device != queries.device:
            raise ValueError("index_find: int64 tensors on one device expected")
    if index_hashes.dim() != 1 or bucket_starts.shape != ((1 << bits) + 1,):
        raise ValueError(f"index_find: index_hashes (n,) and bucket_starts "
                         f"({(1 << bits) + 1},) expected")
    if out is not None and (out.dtype != torch.int64 or out.shape != queries.shape or
                            out.device != queries.device or not out.is_contiguous()):
        raise ValueError("index_find: out must be a contiguous int64 tensor of the queries' "
                         "shape on their device")
    if queries.device.type == "cpu":
        found = index_find_device(index_hashes, bucket_starts, bits, queries)
        return found if out is None else out.copy_(found)
    lib = _kernels(queries, "index_find")
    hashes, buckets, q = (x.contiguous() for x in (index_hashes, bucket_starts, queries))
    out = torch.empty_like(q) if out is None else out
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = lib.index_find_launch(
            hashes.data_ptr(), hashes.shape[0], buckets.data_ptr(), bits, q.data_ptr(),
            q.numel(), out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(err, "index_find")
    with _count_lock:
        launches_find += 1
    return out


def syncmers_scan(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int, M: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """codes (B, L) uint8 {0..3, 4 = N}, lengths (B,) int32 -> the
    canonical closed syncmers of each read by the reference's automaton:
    (positions (B, M) int32, -1 padded; hashes (B, M) int64 with the
    uint64 bits, 0 padded; counts (B,) int32), as
    `seed_device.syncmers_scan_plain`. CPU tensors take that plain
    version; CUDA tensors launch csrc/syncmers_scan.cu, a warp a read
    (windows decided in closed form, the automaton replayed only at tied
    windows)."""
    global launches_syncmers
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be (B, L) uint8, got {tuple(codes.shape)} {codes.dtype}")
    B, L = codes.shape
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or lengths.device != codes.device:
        raise ValueError("lengths must be (B,) int32 on the codes' device")
    if not (1 <= s <= k <= 32 and 1 <= t <= k - s + 1 and M >= 1):
        raise ValueError(f"unsupported syncmer parameters k={k} s={s} t={t} M={M}")
    if codes.device.type == "cpu":
        return syncmers_scan_plain(codes, lengths, k, s, t, M)
    lib = _kernels(codes, "syncmers_scan")
    pos = torch.empty((B, M), dtype=torch.int32, device=codes.device)
    hashes = torch.empty((B, M), dtype=torch.int64, device=codes.device)
    counts = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B == 0:
        return pos, hashes, counts
    codes, lengths = codes.contiguous(), lengths.contiguous()
    with torch.cuda.device(codes.device):
        err = lib.syncmers_scan_launch(
            codes.data_ptr(), lengths.data_ptr(), B, L, k, s, t, M, pos.data_ptr(),
            hashes.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(codes.device).cuda_stream)
    _check_launch(err, "syncmers_scan")
    with _count_lock:
        launches_syncmers += 1
    return pos, hashes, counts
