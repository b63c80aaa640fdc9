"""The run lookup kernel of ``--shard-index`` (csrc/find_runs.cu), behind
wrappers that take their plain PyTorch versions (ops/shard_find.py) for
CPU tensors and launch the kernel, or raise, for CUDA tensors.

It replaces no Pallas kernel: in rabbitsalign_tpu the lookup is an XLA
program under shard_map, `ShardedIndex._build_routed` and `_build`
(rabbitsalign_tpu/parallel/sharding.py:253-323). `find_runs` is its
search and `gather_runs` its run gather; each equals its plain version
exactly.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .seed_cuda import _check_launch, _kernels
from .shard_find import find_runs_plain, gather_runs_plain

# launches of the find_runs.cu kernels by find_runs and gather_runs;
# plain-version calls and empty batches (nothing to launch) are not
# counted. Mapping workers launch from several threads, so updates hold
# _count_lock.
launches_find_runs = 0
_count_lock = threading.Lock()


def _counted() -> None:
    global launches_find_runs
    with _count_lock:
        launches_find_runs += 1


def find_runs(hashes: torch.Tensor, size: int, start: int, buckets: torch.Tensor, bits: int,
              queries: torch.Tensor, top0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search one shard for each query: (gpos, count) (nq,) int64, as
    `shard_find.find_runs_plain`. hashes (m,) int64 with the uint64 bits,
    sorted as uint64, `size` real entries then padding; buckets (nb,)
    int64, rows top0 .. top0 + nb - 1 of the index's bucket table (the
    whole table, 2**bits + 1 rows, with top0 = 0); queries (nq,) int64; on
    one device. CPU tensors take the plain version; CUDA tensors launch
    the kernel, one thread a query."""
    if hashes.dtype != torch.int64 or queries.dtype != torch.int64 or \
            buckets.dtype != torch.int64:
        raise ValueError("find_runs: int64 hashes, buckets and queries expected")
    nb = buckets.shape[0] if buckets.dim() == 1 else 0
    if hashes.dim() != 1 or queries.dim() != 1 or not 0 <= size <= hashes.numel() or \
            not hashes.numel() or not 2 <= nb <= (1 << bits) + 1 - top0 or top0 < 0:
        raise ValueError(f"find_runs: hashes (m,) with m > 0 and 0 <= size <= m, buckets "
                         f"(nb,) with 2 <= nb <= {(1 << bits) + 1} - top0 and queries (nq,) "
                         f"expected")
    if not hashes.device == buckets.device == queries.device:
        raise ValueError("find_runs: tensors on one device expected")
    if queries.device.type == "cpu":
        return find_runs_plain(hashes, size, start, buckets, bits, queries, top0)
    lib = _kernels(queries, "find_runs")
    hashes, buckets, queries = (x.contiguous() for x in (hashes, buckets, queries))
    gpos = torch.empty_like(queries)
    count = torch.empty_like(queries)
    if not queries.numel():
        return gpos, count
    with torch.cuda.device(queries.device):
        err = lib.find_runs_launch(
            hashes.data_ptr(), hashes.shape[0], size, start, buckets.data_ptr(), nb, bits, top0,
            queries.data_ptr(), queries.shape[0], gpos.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream)
    _check_launch(err, "find_runs")
    _counted()
    return gpos, count


def gather_runs(positions: torch.Tensor, packed: torch.Tensor, gpos: torch.Tensor,
                count: torch.Tensor, start: int, cap: int, dst: Optional[torch.Tensor],
                out_pos: torch.Tensor, out_packed: torch.Tensor) -> None:
    """Copy each found key's first min(count, cap) run rows of one shard
    into out_pos and out_packed at rows dst[i] onwards (in place, so that
    several shards can fill one buffer), as
    `shard_find.gather_runs_plain`. positions and packed (m,) int32;
    gpos, count (and dst, or None for row i * cap) (nq,) int64 from
    `find_runs`; out_pos and out_packed flat int32, long enough for every
    row written. CPU tensors take the plain version; CUDA tensors launch
    the kernel, one thread a key (a warp for each run longer than 8 rows)."""
    nq = count.shape[0]
    if positions.dtype != torch.int32 or packed.dtype != torch.int32 or \
            out_pos.dtype != torch.int32 or out_packed.dtype != torch.int32:
        raise ValueError("gather_runs: int32 positions, packed and outputs expected")
    if gpos.dtype != torch.int64 or count.dtype != torch.int64 or gpos.shape != (nq,) or \
            (dst is not None and (dst.dtype != torch.int64 or dst.shape != (nq,))):
        raise ValueError("gather_runs: (nq,) int64 gpos, count and dst expected")
    if packed.shape != positions.shape or out_packed.shape != out_pos.shape or \
            out_pos.dim() != 1 or cap < 1:
        raise ValueError("gather_runs: positions and packed (m,), flat outputs, cap >= 1 expected")
    tensors = [positions, packed, gpos, count, out_pos, out_packed] + ([] if dst is None else [dst])
    if any(x.device != count.device for x in tensors):
        raise ValueError("gather_runs: tensors on one device expected")
    if count.device.type == "cpu":
        gather_runs_plain(positions, packed, gpos, count, start, cap, dst, out_pos, out_packed)
        return
    lib = _kernels(count, "gather_runs")
    if not (out_pos.is_contiguous() and out_packed.is_contiguous()):
        raise ValueError("gather_runs: contiguous outputs expected")
    if dst is None and out_pos.numel() < nq * cap:
        raise ValueError(f"gather_runs: dense outputs of {nq * cap} rows expected")
    if not nq:
        return
    positions, packed, gpos, count = (x.contiguous() for x in (positions, packed, gpos, count))
    dst = None if dst is None else dst.contiguous()
    with torch.cuda.device(count.device):
        err = lib.gather_runs_launch(
            positions.data_ptr(), packed.data_ptr(), gpos.data_ptr(), count.data_ptr(), start,
            None if dst is None else dst.data_ptr(), nq, cap, out_pos.data_ptr(),
            out_packed.data_ptr(), torch.cuda.current_stream(count.device).cuda_stream)
    _check_launch(err, "gather_runs")
    _counted()
