"""The device seeding kernels of ``--device-seed``: randstrobe seeding
(csrc/seed_randstrobes.cu) and the index lookup (csrc/index_find.cu),
behind wrappers that take their plain PyTorch versions
(ops/seed_device.py) for CPU tensors and launch the kernel, or raise, for
CUDA tensors.

Neither replaces a Pallas kernel: in rabbitsalign_tpu they are XLA ops,
`randstrobes_query_vec` (ops/seed_device.py:432) and `index_find_device`
(:239). Each kernel's output equals its plain version's byte for byte,
unused slots included.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from .seed_device import index_find_device, randstrobes_query_vec

MAX_L = 512  # codes per read, and slots per strand, the seeding kernel takes

# launches of the seeding kernel by seed_randstrobes and of the lookup
# kernel by index_find; plain-version calls and empty batches (nothing to
# launch) are not counted. Mapping workers launch from several threads, so
# updates hold _count_lock.
launches_seed = 0
launches_find = 0
_count_lock = threading.Lock()


def _kernels(x: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    from .cuda_build import load_kernels

    return load_kernels()


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")


def seed_randstrobes(codes: torch.Tensor, lengths: torch.Tensor, k: int, s: int, t: int,
                     w_min: int, w_max: int, q: int, max_dist: int, M: int
                     ) -> Tuple[torch.Tensor, ...]:
    """codes (B, L) uint8 {0..3, 4 = N}, lengths (B,) int32 -> (hash (B,
    2M) int64 with uint64 bits, start (B, 2M) int32, end (B, 2M) int32,
    n_fwd (B,) int32, n_rc (B,) int32, tie (B,) bool), as
    `seed_device.randstrobes_query_vec`. CPU tensors take that plain
    version; CUDA tensors launch the kernel (L and M at most MAX_L)."""
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
        return randstrobes_query_vec(codes, lengths, k, s, t, w_min, w_max, q, max_dist, M)
    lib = _kernels(codes, "seed_randstrobes")
    if L > MAX_L or M > MAX_L:
        raise ValueError(f"seed_randstrobes: the kernel takes L and M up to {MAX_L}, "
                         f"not {L} and {M}")
    codes, lengths = codes.contiguous(), lengths.contiguous()
    dev = codes.device
    h = torch.empty((B, 2 * M), dtype=torch.int64, device=dev)
    coords = torch.empty((2, B, 2 * M), dtype=torch.int32, device=dev)  # start, end
    counts = torch.empty((2, B), dtype=torch.int32, device=dev)
    tie = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return h, coords[0], coords[1], counts[0], counts[1], tie
    with torch.cuda.device(dev):
        err = lib.seed_randstrobes_launch(
            codes.data_ptr(), lengths.data_ptr(), B, L, k, s, t, w_min, w_max,
            ctypes.c_uint64(q & ((1 << 64) - 1)), max_dist, M, h.data_ptr(),
            coords[0].data_ptr(), coords[1].data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
            tie.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "seed_randstrobes")
    with _count_lock:
        launches_seed += 1
    return h, coords[0], coords[1], counts[0], counts[1], tie


def index_find(index_hashes: torch.Tensor, bucket_starts: torch.Tensor, bits: int,
               queries: torch.Tensor) -> torch.Tensor:
    """The first position of each query's hash in the sorted index, or -1,
    with the bucket table's quirk, as `seed_device.index_find_device`.
    index_hashes (n,), bucket_starts (2**bits + 1,) and queries (any
    shape) int64 with uint64 bits, on one device. CPU tensors take the
    plain version; CUDA tensors launch the kernel, one thread a query."""
    global launches_find
    for x in (index_hashes, bucket_starts, queries):
        if x.dtype != torch.int64 or x.device != queries.device:
            raise ValueError("index_find: int64 tensors on one device expected")
    if index_hashes.dim() != 1 or bucket_starts.shape != ((1 << bits) + 1,):
        raise ValueError(f"index_find: index_hashes (n,) and bucket_starts "
                         f"({(1 << bits) + 1},) expected")
    if queries.device.type == "cpu":
        return index_find_device(index_hashes, bucket_starts, bits, queries)
    lib = _kernels(queries, "index_find")
    hashes, buckets, q = (x.contiguous() for x in (index_hashes, bucket_starts, queries))
    out = torch.empty_like(q)
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
