"""One shard's run lookup for ``--shard-index``, in plain PyTorch: the
plain versions of the two entry points of csrc/find_runs.cu.

Counterpart of the per-shard `local` function of
rabbitsalign_tpu/parallel/sharding.py (:254-274), cut in two so the
caller can place the run rows where it wants them: `find_runs_plain` is
its search (the first position and length of each key's equal-hash run,
and the reachable check, which the bucket table gives here), and
`gather_runs_plain` its run gather. Hashes
are int64 with the uint64 bits (ops/seed_device.py), and positions and
packed int32 with the uint32 bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .seed_device import flip, lsr


def find_runs_plain(hashes: torch.Tensor, size: int, start: int, buckets: torch.Tensor,
                    bits: int, queries: torch.Tensor, top0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search one shard: hashes (m,) sorted as uint64, its first `size`
    entries real and the rest 0xFF..F padding; `start` the global index of
    its first entry; buckets (nb,) rows top0 .. top0 + nb - 1 of the
    index's global bucket table (all 2**bits + 1 with top0 = 0), a key's
    row `top - top0` clipped to them; queries (nq,). Returns (gpos,
    count), both (nq,) int64: the global index of the key's first entry
    and the length of its run (over the padded shard, as the JAX `local`),
    both 0 where the key is not found. A key is found when its shard-wide
    lower bound holds it and lies in its bucket's range, clipped to the
    shard's real entries: the JAX package's reachable check, as buckets
    and shards start at runs."""
    fh, fq = flip(hashes), flip(queries)
    lo = torch.searchsorted(fh, fq)
    hi = torch.searchsorted(fh, fq, right=True)
    top = (lsr(queries, 64 - bits) - top0).clamp(0, buckets.shape[0] - 2)
    b_lo = buckets[top] - start
    b_hi = (buckets[top + 1] - start).clamp(max=size)
    in_b = (lo >= b_lo) & (lo < b_hi)
    found = in_b & (hashes[torch.where(in_b, lo, 0)] == queries)
    return torch.where(found, lo + start, 0), torch.where(found, hi - lo, 0)


def gather_runs_plain(positions: torch.Tensor, packed: torch.Tensor, gpos: torch.Tensor,
                      count: torch.Tensor, start: int, cap: int, dst: Optional[torch.Tensor],
                      out_pos: torch.Tensor, out_packed: torch.Tensor) -> None:
    """Copy the first min(count, cap) run rows of each found key from one
    shard's positions and packed (m,) into out_pos and out_packed (flat,
    in place), at rows dst[i] onwards; a key with dst[i] < 0 is skipped.
    dst None places key i at i * cap, the dense (nq, cap) layout of the
    JAX `local`, whose other rows the caller has zeroed (`valid = found &
    row < count`)."""
    nq = count.shape[0]
    dev = count.device
    if dst is None:
        dst = torch.arange(nq, device=dev) * cap
    n = torch.where((count > 0) & (dst >= 0), count.clamp(max=cap), 0)
    key = torch.repeat_interleave(torch.arange(nq, device=dev), n)
    row = torch.arange(key.shape[0], device=dev) - (torch.cumsum(n, 0) - n)[key]
    src = gpos[key] - start + row
    out_pos[dst[key] + row] = positions[src]
    out_packed[dst[key] + row] = packed[src]
