"""The hash-sharded strobemer index of ``--shard-index``.

The index's hash-sorted arrays are cut into contiguous hash ranges, one
shard per entry of the device list, each cut moved down to the start of
its equal-hash run so that every run lives on exactly one shard. A lookup
answers with the full `StrobemerIndex::find` semantics (reference
src/index.hpp:57-147): first-occurrence position, run length, the
repetitive filter, and the run's (position, packed) records, which the
engine's run-fed phase A walks instead of the host index arrays. This is
the whole-genome scale-out design of the JAX package: by default
(`make_mesh()`, `local_devices`) every card this process sees holds one
shard, as every device of the JAX mesh does; a list may also name one
device several times (several shards of one card, or of the CPU in
tests).

Counterpart of rabbitsalign_tpu/parallel/sharding.py. `SENTINEL`,
`shard_bounds` and `shard_index_by_hash` are numpy copies of the functions
there (without the reachable flags: the lookup bounds its search by the
bucket table, which gives the same answers). The mesh is a plain list of
`torch.device`s (`make_mesh`); one shard's lookup is the
`ops/shard_cuda.py` pair `find_runs` and `gather_runs` (the kernel
`csrc/find_runs.cu`, or its plain PyTorch version for CPU tensors), on
the shard's device. Where the JAX package psums the shards' answers over
the mesh, `find_runs` here adds them up on the host; `find_runs_routed`
sends each key only to its owner, and `find_runs_compact`, the pipeline's
lookup, does that and also builds the compacted run records the engine
reads: on the device when every shard is on one device, else each device
gathers its own keys' runs and the host places them by key.
`sharded_find` and `data_parallel_extend` are the JAX module's one-off
helpers over a device list: a lookup's positions, and the extend forward
with the batch split over the devices.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import shard_cuda
from ..ops.sw_cuda import sw_forward

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

# shard uploads queue on the constructing thread's stream; the lock and
# the synchronize in ShardedIndex keep one run's uploads whole before any
# worker reads them from a stream of its own
_UPLOAD_LOCK = threading.Lock()


def local_devices(device="cuda") -> List[torch.device]:
    """The counterpart of `jax.local_devices()`: for "cuda" every card
    this process sees ([cuda:0 ... cuda:k-1], as CUDA_VISIBLE_DEVICES
    selects them), for an indexed "cuda:i" that card, for "cpu" [cpu].
    CUDA without a card raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    if device.index is not None:
        return check_devices([device])
    _require_cards()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _require_cards() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu "
                           "for the plain PyTorch versions, or --no-tpu for host alignment)")


def check_devices(devices, what: str = "every entry") -> List[torch.device]:
    """`devices` as a list of `torch.device`s, a CUDA one with its index
    (cuda -> cuda:0). Raises for an empty list, a list that mixes device
    types or names one other than cpu and cuda, and a card that this
    process does not see. Entries may repeat."""
    devices = [torch.device(d) for d in devices]
    types = {d.type for d in devices}
    if not devices or len(types) != 1 or not types <= {"cpu", "cuda"}:
        raise ValueError(f"{what} on one device type, cpu or cuda, expected, got {devices}")
    if types == {"cuda"}:
        _require_cards()
        devices = [torch.device("cuda", d.index or 0) for d in devices]
        n = torch.cuda.device_count()
        absent = sorted({str(d) for d in devices if d.index >= n})
        if absent:
            raise RuntimeError(f"no such CUDA device: {', '.join(absent)} (this process sees "
                               f"{n} card(s))")
    return devices


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The devices that hold the shards: with no count every local device
    (`local_devices`), one shard each, as the JAX package's `make_mesh()`;
    else `n_devices` entries of the given device (several shards on one
    card, or on the CPU in tests). A CUDA mesh without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--shard-index on cuda: no CUDA device is available (use "
                           "--device cpu for the plain PyTorch lookup)")
    if n_devices is None:
        return local_devices(device)
    return check_devices([device], "the mesh") * n_devices


def shard_bounds(hashes: np.ndarray, n_shards: int) -> np.ndarray:
    """Run-aligned contiguous cut points into the hash-sorted arrays:
    n_shards+1 bounds, each cut moved DOWN to the first entry of its
    equal-hash run so no run straddles two shards."""
    n = hashes.shape[0]
    if n == 0:
        return np.zeros(n_shards + 1, dtype=np.int64)
    ideal = (np.arange(1, n_shards) * n) // n_shards
    cuts = np.searchsorted(hashes, hashes[np.minimum(ideal, n - 1)],
                           side="left")
    return np.concatenate([[0], cuts, [n]]).astype(np.int64)


def shard_index_by_hash(hashes: np.ndarray, positions: np.ndarray, packed: np.ndarray,
                        n_shards: int):
    """Split the hash-sorted randstrobe arrays into n contiguous shards
    whose cuts are moved DOWN to equal-hash run starts, so no run ever
    straddles two shards (a query hash then belongs to exactly one shard
    and per-shard counts/runs are globally correct). Shards are padded to
    a common width with the 0xFF..F sentinel hash (which, like the
    reference's guard entry, can shadow a genuine all-ones hash — a
    ~1/2^64 event the reference accepts too).

    Returns (hashes (n, m), positions (n, m), packed (n, m),
    shard_starts (n,))."""
    n = hashes.shape[0]
    bounds = shard_bounds(hashes, n_shards)
    m = int(np.max(np.diff(bounds))) if n else 1
    h = np.full((n_shards, m), SENTINEL, dtype=np.uint64)
    p = np.zeros((n_shards, m), dtype=positions.dtype)
    k = np.zeros((n_shards, m), dtype=packed.dtype)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        h[s, : hi - lo] = hashes[lo:hi]
        p[s, : hi - lo] = positions[lo:hi]
        k[s, : hi - lo] = packed[lo:hi]
    return h, p, k, bounds[:-1].astype(np.int64)


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class ShardedIndex:
    """The strobemer index hash-sharded over a list of devices, with the
    full `StrobemerIndex::find` lookup semantics evaluated on them.

    `index` is any object with ``hashes`` (uint64), ``positions`` and
    ``packed`` (uint32), ``randstrobe_start_indices`` (its bucket table),
    ``bits`` and ``filter_cutoff``. Shard s lives on `devices[s]`; the
    entries are of one device type and may repeat. Shard s holds hashes as
    int64 with the uint64 bits, positions and packed as int32 with the
    uint32 bits; the bucket table is there once a distinct device, as
    int64. They are uploaded once, when the object is made; one object
    serves every mapping worker, each looking up on its own streams."""

    def __init__(self, devices, index):
        t0 = time.perf_counter()
        self.devices = check_devices(devices, "every shard")
        self.device = self.devices[0]
        n_shards = self.n_shards = len(self.devices)
        h, p, k, starts = shard_index_by_hash(index.hashes, index.positions, index.packed,
                                              n_shards)
        self.bits = int(index.bits)
        with _UPLOAD_LOCK:
            # a copy: the table may be a read-only memmap (--mmap-index)
            table = np.array(index.randstrobe_start_indices, np.uint64).view(np.int64)
            self._tables = {d: _put(table, d) for d in dict.fromkeys(self.devices)}
            self._buckets = self._tables[self.device]
            self._shards = [(_put(h[s].view(np.int64), d), _put(p[s].view(np.int32), d),
                             _put(k[s].view(np.int32), d)) for s, d in enumerate(self.devices)]
            for d in self._tables:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        self.starts = [int(x) for x in starts]
        self.width = int(h.shape[1])  # entries a shard, padding included
        n = index.hashes.shape[0]
        ends = np.concatenate([starts[1:], [n]])
        self.shard_sizes = [int(x) for x in ends - starts]
        self.filter_cutoff = int(index.filter_cutoff)
        # the syncmer length the NAM walk of chain/sharded_nams.py needs; a
        # bare index of arrays has none
        self._k = index.k() if hasattr(index, "k") else None
        # host routing table: shard s owns keys in
        # [start_hash[s], start_hash[s+1]) — runs never straddle cuts, so
        # ownership is unique. An empty shard shares its successor's
        # start hash; searchsorted(side="right") then routes past it.
        sh = np.full(n_shards, SENTINEL, dtype=np.uint64)
        for s in range(n_shards):
            if starts[s] < n:
                sh[s] = index.hashes[starts[s]]
        self._start_hash = sh
        # route only to non-empty shards: 0xFFFF...F is both a legal hash
        # and the empty-shard marker
        nonempty = starts < ends
        self._route_nonempty = np.maximum.accumulate(
            np.where(nonempty, np.arange(n_shards), 0))
        self.build_s = time.perf_counter() - t0

    def k(self) -> int:
        return self._k

    def _lookup(self, s: int, keys: np.ndarray):
        """Search shard s for `keys` (uint64) on its device: (gpos,
        count), (nq,) int64 tensors there."""
        dev = self.devices[s]
        return shard_cuda.find_runs(self._shards[s][0], self.shard_sizes[s], self.starts[s],
                                    self._tables[dev], self.bits, _put(keys.view(np.int64), dev))

    def _gather(self, s: int, gpos, count, cap: int, dst, out_pos, out_packed) -> None:
        _, p, k = self._shards[s]
        shard_cuda.gather_runs(p, k, gpos, count, self.starts[s], cap, dst, out_pos, out_packed)

    def _dense(self, keys: np.ndarray, cap: int, routes) -> dict:
        """Every (shard, key indices) of `routes` searched and gathered into
        (NQ, cap) rows, the answers added up (zero off a key's owner)."""
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        nq = keys.shape[0]
        gpos = np.zeros(nq, np.int64)
        count = np.zeros(nq, np.int64)
        runp = np.zeros((nq, cap), np.int32)
        runk = np.zeros((nq, cap), np.int32)
        for s, idx in routes(keys):
            g, c = self._lookup(s, np.ascontiguousarray(keys[idx]))
            rp = torch.zeros(c.numel() * cap, dtype=torch.int32, device=self.devices[s])
            rk = torch.zeros_like(rp)
            self._gather(s, g, c, cap, None, rp, rk)
            gpos[idx] += g.cpu().numpy()
            count[idx] += c.cpu().numpy()
            runp[idx] += rp.cpu().numpy().reshape(-1, cap)
            runk[idx] += rk.cpu().numpy().reshape(-1, cap)
        return {
            "position": np.where(count > 0, gpos, -1),  # a found run has an entry
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_positions": runp.view(np.uint32),
            "run_packed": runk.view(np.uint32),
        }

    def find_runs(self, keys: np.ndarray, cap: int):
        """Full lookup for a batch of query hashes: every shard searches
        every key, and the answers (zeros off the owning shard) are added.

        Returns a dict of numpy arrays:
          position  (NQ,)  int64  — global first-occurrence index, -1 if
                                    absent (== StrobemerIndex.find)
          count     (NQ,)  int64  — equal-hash run length
                                    (== get_count at that position)
          filtered  (NQ,)  bool   — count > filter_cutoff
                                    (== is_filtered at that position)
          run_positions (NQ, cap) uint32 — the run's strobe1 positions
          run_packed    (NQ, cap) uint32 — the run's (ref_id<<8|offset)
        Run rows beyond min(count, cap) are zero."""
        return self._dense(keys, cap, lambda k: [(s, slice(None)) for s in range(self.n_shards)])

    def _route(self, keys: np.ndarray):
        """[(shard, the indices of the keys it owns, or a slice of all of
        them)] for every shard that owns a key."""
        if self.n_shards == 1:
            return [(0, slice(None))]
        owner = np.searchsorted(self._start_hash, keys, side="right") - 1
        np.clip(owner, 0, self.n_shards - 1, out=owner)
        owner = self._route_nonempty[owner]  # never route to an empty shard
        return [(s, idx) for s in range(self.n_shards)
                if (idx := np.flatnonzero(owner == s)).size]

    def find_runs_routed(self, keys: np.ndarray, cap: int):
        """`find_runs` with host-side hash routing: each key is sent ONLY
        to its owning shard (contiguous hash ranges make ownership unique
        and host-computable). Element-equal to `find_runs`."""
        return self._dense(keys, cap, self._route)

    def find_runs_compact(self, keys: np.ndarray, cap: Optional[int] = None):
        """The routed lookup in the layout the engine's run feed reads,
        built so that no dense (NQ, cap) matrix is made or copied: the run
        records of each key that is walked (found, with count <= cap; cap
        defaults to the filter cutoff) back to back in key order.

        Returns a dict of numpy arrays: count (NQ,) int64; filtered (NQ,)
        bool (count > filter_cutoff); run_off (NQ,) int64, the offset of
        the key's records, -1 for a key that is not walked; run_positions
        and run_packed (R,) uint32, R the sum of the walked keys' counts
        (one zero row if none). Equal to compacting
        `find_runs_routed(keys, cap)` on the host."""
        cap = self.filter_cutoff if cap is None else int(cap)
        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64))
        parts = [(s, idx, *self._lookup(s, np.ascontiguousarray(keys[idx])))
                 for s, idx in self._route(keys)]
        if len(self._tables) > 1:
            return self._compact_across_devices(keys.shape[0], cap, parts)
        nq = keys.shape[0]
        dev = self.device
        if self.n_shards == 1:
            count = parts[0][3]  # every key on the one shard, in order
            at = {0: None}
        else:
            count = torch.zeros(nq, dtype=torch.int64, device=dev)
            at = {s: torch.from_numpy(idx).to(dev) for s, idx, *_ in parts}
            for s, _, _, c in parts:
                count[at[s]] = c
        walk = (count > 0) & (count <= cap)
        width = torch.where(walk, count, 0)
        ends = torch.cumsum(width, 0)
        run_off = torch.where(walk, ends - width, -1)
        n_rows = int(ends[-1]) if nq else 0
        run_pos = torch.zeros(max(n_rows, 1), dtype=torch.int32, device=dev)
        run_packed = torch.zeros_like(run_pos)
        for s, _, gpos, c in parts:
            self._gather(s, gpos, c, cap, run_off if at[s] is None else run_off[at[s]],
                         run_pos, run_packed)
        count = count.cpu().numpy()
        return {
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_off": run_off.cpu().numpy(),
            "run_positions": run_pos.cpu().numpy().view(np.uint32),
            "run_packed": run_packed.cpu().numpy().view(np.uint32),
        }

    def _compact_across_devices(self, nq: int, cap: int, parts) -> dict:
        """`find_runs_compact` over shards on several devices. The counts
        come to the host, which lays out the run offsets; each shard
        gathers its own walked keys' runs back to back into a buffer on
        its device, which comes back in one copy (pinned on a card); the
        host places each key's rows at its offset."""
        count = np.zeros(nq, np.int64)
        for _, idx, _, c in parts:
            count[idx] = c.cpu().numpy()
        walk = (count > 0) & (count <= cap)
        width = np.where(walk, count, 0)
        ends = np.cumsum(width)
        run_off = np.where(walk, ends - width, -1)
        rows = np.zeros((2, max(int(ends[-1]) if nq else 0, 1)), np.int32)
        copies = []
        for s, idx, gpos, c in parts:
            w = width[idx]
            local_ends = np.cumsum(w)
            n_local = int(local_ends[-1])
            if not n_local:
                continue
            dev = self.devices[s]
            local = torch.empty((2, n_local), dtype=torch.int32, device=dev)
            self._gather(s, gpos, c, cap, _put(np.where(w > 0, local_ends - w, -1), dev),
                         local[0], local[1])
            host = local
            if dev.type == "cuda":
                host = torch.empty(local.shape, dtype=local.dtype, pin_memory=True)
                host.copy_(local, non_blocking=True)
            # local row j of the shard's walked keys goes to global row
            # run_off[key] + (j - its local offset)
            walked = idx[w > 0]
            shift = np.repeat(run_off[walked] - (local_ends - w)[w > 0], width[walked])
            copies.append((dev, host, shift + np.arange(n_local)))
        for dev, host, dst in copies:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            rows[:, dst] = host.numpy()
        return {
            "count": count,
            "filtered": count > self.filter_cutoff,
            "run_off": run_off,
            "run_positions": rows[0].view(np.uint32),
            "run_packed": rows[1].view(np.uint32),
        }


def sharded_find(devices, index, queries, cap: Optional[int] = None) -> np.ndarray:
    """A one-off `StrobemerIndex.find` over an index sharded across
    `devices` (`make_mesh()` lists the local cards): the global
    first-occurrence positions (int64, -1 if absent), the bucket table's
    quirk for the smallest hash included."""
    si = ShardedIndex(devices, index)
    return si.find_runs(queries, cap or max(1, si.filter_cutoff))["position"]


def data_parallel_extend(devices, params, q_codes, t_codes, qlen, tlen):
    """The extend forward with the batch split over `devices`: q_codes
    (B, Q) and t_codes (B, T) u8, qlen and tlen (B,), B a multiple of
    len(devices). Shard i, rows [i B/n, (i+1) B/n), runs on devices[i]
    through `sw_forward` (the kernel on a card, the plain version on the
    CPU); a device may be named more than once. Returns (score, t_end,
    q_end) (B,) int32 on devices[0] and total_cells, the int64 sum of
    qlen * tlen over every shard."""
    devices = check_devices(devices, "every shard")
    q_codes, t_codes, qlen, tlen = (torch.as_tensor(x) for x in (q_codes, t_codes, qlen, tlen))
    B, n = q_codes.shape[0], len(devices)
    if B % n:
        raise ValueError(f"the batch of {B} pairs does not split over {n} devices")
    width = B // n
    outs, cells = [], torch.zeros((), dtype=torch.int64, device=devices[0])
    for i, dev in enumerate(devices):
        rows = slice(i * width, (i + 1) * width)
        ql = qlen[rows].to(dev, torch.int32)
        tl = tlen[rows].to(dev, torch.int32)
        score, t_end, q_end, _ = sw_forward(q_codes[rows].to(dev, torch.uint8).T,
                                            t_codes[rows].to(dev, torch.uint8).T, ql, tl, params)
        outs.append(torch.stack([score, t_end, q_end]).to(devices[0]))
        cells += (ql.to(torch.int64) * tl.to(torch.int64)).sum().to(devices[0])
    score, t_end, q_end = torch.cat(outs, dim=1)
    return score, t_end, q_end, cells
