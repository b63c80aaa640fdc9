"""Production chunk pipeline around the native engine: one mapping
thread (`NativePipeline`) or N workers (`ThreadedNativePipeline`), and
the device prewarm.

Drives the two-phase schedule of the reference's async workers
(reference src/pc.cpp:1206-1510): C++ phase A of a chunk plans its
gapped-extension jobs into (Q, T) buckets; each batch is packed natively
(q2 layout), uploaded and extended on the device (ops/extend_device.py);
C++ phase B then finishes the chunk and writes its SAM/PAF bytes. On a
card the engine fills each batch straight into pinned memory, and one
call into the kernel library (`extend_q2_enqueue`) queues the upload, the
two kernels and the copy of the packed results back on the current CUDA
stream, behind one CUDA event, so phase A of the next chunks runs while
the GPU extends this one; `finish_chunk` waits on the event.
Each threaded worker enqueues on a CUDA stream of its own on every card
(the current stream is per thread), as GASAL2 gives each host thread its
own streams.

What a run does on its devices, and what it keeps there, is decided and
uploaded once, by its `DeviceRun`, which every mapping thread of the run
shares. Its device list defaults to every local card (`local_devices`,
the counterpart of `jax.local_devices()`): the extend batches go to its
entries in turn, each card holding one copy of the genome for the whole
run, as the JAX package's `_dispatch` spreads them over its local
devices. Seeding stays on the first entry.

Wherever the extend runs on a CUDA card, phase A takes each chunk's
seeds, index hits and kept run hits from that card (`DeviceRun.device_seed`;
ops/seed_device.py:seed_and_find, two kernels, and
ops/chain_cuda.py:walk_hits_compact, the run walk, against the index
arrays uploaded once a run, in set-up); reads the closed form cannot
seed exactly (a min-queue tie, or longer than SEED_L) are seeded by the
engine itself, and a read whose hits overflow its room is walked there.
``--device-seed`` names that default, and on the CPU asks for the
kernels' plain versions.

With ``--shard-index`` (which takes precedence over seeding on the device)
every index lookup of phase A is served by the hash-sharded index
(parallel/sharding.py, one shard an entry of the device list): the engine seeds the chunk
without touching the index, the strobes' hashes go through one batched
lookup, and the engine maps the chunk from the prefetched run records.
In a multi-host pod (``--num-nodes``, parallel/multihost.py) one
NativePipeline a host maps its share of the chunks (`map_file_sharded`),
and with ``--pod-index-peers`` the lookups go to the pod-split index
(`PodShardedIndex`, which presents the same `find_runs_compact`).

Without device extension (``--no-tpu``, or gap_extend >= gap_open) the
engine's built-in SSW resolves every gapped job on the host, and seeding
stays on the host too, as it does under ``--device cpu``.

Every boundary of a chunk's path is a `Span`: the reader's wait, the
hand-off to the workers, a worker's set-up and its wait for input, then
for chunk c phase A, the extend's dispatch, the wait on the device, phase
B and the ordered output; the seeding on the device is a span inside
phase A. Each adds its seconds to a timer of `timers()`
(summed over the workers) and, while a torch profiler runs, is a
`record_function` named ``rsb.<name>`` (``rsb.<name>#<c>`` for a chunk's
span), on the trace's clock beside the card's kernels. `counters()`
counts at the same boundaries: the records the engine seeded itself
and those whose runs it walked, chunks, the extend's jobs, DP cells and
upload bytes, and the jobs left to the host.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..native.engine import ENGINE_BUCKETS, NativeEngine, NativeReader, engine_available
from ..ops.chain_cuda import walk_hits_compact
from ..ops.extend_device import (extend_batch_packed_resident_q2, extend_q2_enqueue,
                                 q2_staging, resident_ref_codes)
from ..ops.front_device import walk_views
from ..ops.seed_device import seed_and_find, strobe_views
from ..ops.sw_cuda import SwParams
from ..parallel.sharding import ShardedIndex, check_devices, local_devices, make_mesh
from ..utils.logger import logger


def boost_mapping_thread(level: int = -5) -> bool:
    """Renice the CALLING thread (Linux: setpriority with a tid applies
    per-thread) so phase A outranks the in-process client threads
    (here: the CUDA runtime's) under CFS when they contend for cores. A
    -5 nice delta shifts the contended share toward the mapping threads
    without starving the client (unlike SCHED_FIFO, which would stall
    uploads of the previous chunk for the whole phase-A burst). No-op
    without privileges or on non-Linux. ``RSB_RENICE=0`` disables,
    ``RSB_RENICE=n`` overrides the level."""
    env = os.environ.get("RSB_RENICE", "")
    if env == "0":
        return False
    if env:
        try:
            level = int(env)
        except ValueError:
            pass
    try:
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid, level)
        return True
    except (AttributeError, PermissionError, OSError):
        return False


def pin_worker_thread(wid: int):
    """Pin the CALLING thread to one allowed CPU, round-robin by worker
    id — the analog of the reference's consumer-thread affinity
    (reference src/pc.cpp:519-527 pins worker i to core i). Keeps each
    worker's index/cache working set on one core. Returns the cpu id, or
    None when pinning is unavailable (non-Linux, empty mask)."""
    try:
        allowed = sorted(os.sched_getaffinity(0))
        if not allowed:
            return None
        cpu = allowed[wid % len(allowed)]
        # pid 0 = the calling THREAD for sched_setaffinity on Linux
        os.sched_setaffinity(0, {cpu})
        return cpu
    except (AttributeError, OSError):
        return None


def extends_on_device(use_device: bool, aln_params) -> bool:
    """The gap rule: a run that asks for the device extend (`use_device`,
    off under --no-tpu) gets it only where gap extension costs less than
    opening. ssw.c's striped lazy-F pruning diverges from the device
    kernel's textbook DP exactly when gap extension is as cheap as
    opening (O == E): host SSW keeps byte parity with the reference there
    (E > O is rejected by the CLI already)."""
    return use_device and aln_params.gap_extend < aln_params.gap_open


def _signed_bits(a: np.ndarray) -> np.ndarray:
    """A uint64 or uint32 array as int64 or int32 with the same bits;
    read-only arrays (the memmaps of --mmap-index) are copied, as
    torch.from_numpy needs a writable one."""
    a = np.ascontiguousarray(a)
    a = a.view(np.int64 if a.dtype.itemsize == 8 else np.int32)
    return a if a.flags.writeable else a.copy()


def _uploaded(device: torch.device) -> None:
    """Wait for an upload to `device`, queued on this thread's stream:
    the workers read it from streams of their own."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _seed_index_on(index, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The index on `device` for seeding, lookups and the run walk there:
    (hashes int64, bucket starts int64, positions int32, packed int32,
    each with the numpy arrays' bits; 145 MB at 40 Mbp)."""
    arrays = tuple(torch.from_numpy(_signed_bits(a)).to(device)
                   for a in (index.hashes, index.randstrobe_start_indices,
                             index.positions, index.packed))
    _uploaded(device)
    return arrays


# the engine's rescue walk hard-stops at count > 1000 regardless of the
# rescue cutoff (reference nam.cpp take-rule `|| rh.count > 1000`), so no
# rescued strobe past it is looked up
RESCUE_RUN_CAP = 1000


def build_sharded_index(index, device: torch.device, devices=None) -> ShardedIndex:
    """The --shard-index index: one shard an entry of `devices`, by
    default of `local_devices(device)` (a CUDA device without a card
    raises)."""
    return ShardedIndex(make_mesh(None, device) if devices is None else devices, index)


class DeviceRun:
    """What one run does on its devices and keeps there, decided and
    uploaded once and shared by all of its mapping threads: a
    `ThreadedNativePipeline` builds one for its workers, a
    `NativePipeline` built alone its own. The devices hold one seed index
    and one genome a distinct device, however many threads and `map_file`
    calls the run has."""

    def __init__(self, index, aln_params, use_device: bool = True, device="cuda",
                 devices=None, device_seed: bool = False, shard_index: bool = False,
                 sharded_index: Optional[ShardedIndex] = None):
        self.use_device = extends_on_device(use_device, aln_params)
        if use_device and not self.use_device:
            logger.info(
                "gap_extend >= gap_open: device extension disabled to "
                "preserve byte-parity with the reference's ssw semantics "
                "(host SSW resolves all gapped alignments)")
        # --shard-index: the shards stay on the devices even with --no-tpu,
        # which turns off only the extend
        self.shard_index = bool(shard_index)
        # the extend's devices, in turn (`NativePipeline._dispatch`): those
        # given, else every local one where the run needs a device
        if devices is not None:
            self.devices = check_devices(devices)
        elif self.use_device or self.shard_index:
            self.devices = local_devices(device)
        else:
            self.devices = [torch.device(device)]
        self.device = self.devices[0]
        # phase A seeds, looks up and walks each chunk on the first device
        # wherever the extend runs on a CUDA card (--device-seed names that
        # default), on the CPU only where `device_seed` asks for the plain
        # versions, far slower than the engine's host seeding; the sharded
        # index takes precedence
        self.device_seed = (self.use_device and not self.shard_index
                            and (self.device.type == "cuda" or device_seed))
        self.sharded_index = sharded_index
        if self.shard_index and sharded_index is None:
            self.sharded_index = build_sharded_index(index, self.device, self.devices)
        # the cards a mapping thread enqueues on, on streams of its own
        self.cards = ([d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
                      if self.use_device or self.shard_index else [])
        self.sw = (SwParams(aln_params.match, aln_params.mismatch, aln_params.gap_open,
                            aln_params.gap_extend) if self.use_device else None)
        # phase A's index, uploaded here, in set-up
        self.seed_index = _seed_index_on(index, self.device) if self.device_seed else None
        self._genomes: dict = {}  # device -> its resident genome
        # the workers set up concurrently: unlocked, each would upload a copy
        self._lock = threading.Lock()

    def genomes(self, engine) -> list:
        """The resident genome of each entry of `devices` (an entry
        repeated shares its copy), from `engine.ref_codes()` on the first
        call, one upload a distinct device."""
        with self._lock:
            if not self._genomes:
                codes = engine.ref_codes()
                for d in dict.fromkeys(self.devices):
                    self._genomes[d] = resident_ref_codes(codes, d)
                    _uploaded(d)
            return [self._genomes[d] for d in self.devices]


def _at_least_one(a: np.ndarray) -> np.ndarray:
    """The engine takes a pointer per array: an empty one gets an element."""
    return a if a.size else np.zeros(1, a.dtype)


# the pipeline's own timers (seconds, thread-seconds once summed over
# workers), beside the engine's phase_a_s, seed_nam_s, host_align_s and
# phase_b_s: the spans' keys, set_device_results' time, and the whole
# mapping thread's (a worker from start to exit; the single pipeline's
# mapping loop)
SPAN_TIMERS = ("read_wait_s", "handoff_wait_s", "worker_setup_s", "input_wait_s",
               "device_seed_s", "dispatch_s", "device_wait_s", "device_results_s", "emit_s",
               "worker_s")
# the pipeline's own counters, beside the engine's (native_batches: the
# extend batches that went through the one native enqueue, every batch on
# a card and none on the CPU)
EXTEND_COUNTERS = ("chunks", "device_jobs", "device_cells", "upload_bytes", "native_batches")

_autograd_profiler = torch.autograd.profiler


class Span:
    """One span of a chunk's path. On exit its seconds (`perf_counter`)
    are added to `timers[key]` (no key: none). While a torch profiler
    runs it is also a `record_function` named ``rsb.<name>``, with
    ``#<chunk>`` for a chunk's span (torch's ``ProfilerStep#N``
    convention: the chrome trace keeps no arguments, so the chunk index,
    which all of a chunk's spans share, goes in the name). Without a
    profiler it costs two clock reads, a flag test and an add."""

    __slots__ = ("timers", "key", "t0", "rf")

    def __init__(self, timers: dict, key: Optional[str], name: str,
                 chunk: Optional[int] = None):
        self.timers = timers
        self.key = key
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(
                f"rsb.{name}" if chunk is None else f"rsb.{name}#{chunk}")

    def __enter__(self) -> None:
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        if self.key is not None:
            self.timers[self.key] += dt


def _summed(dicts) -> dict:
    total: dict = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


class NativePipeline:
    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        use_device: bool = True,
        batch_size: int = 1024,
        device="cuda",
        device_seed: bool = False,
        shard_index: bool = False,
        sharded_index: Optional[ShardedIndex] = None,
        devices=None,
        run: Optional[DeviceRun] = None,
    ):
        """`run`: the device state that the mapping threads of one run
        share; without it the pipeline builds its own from the device
        keywords, which are read only then."""
        self.engine = NativeEngine(
            index, index_parameters, references, aln_params, map_param,
            read_group_id,
        )
        self.batch_size = batch_size
        if run is None:
            run = DeviceRun(index, aln_params, use_device, device, devices, device_seed,
                            shard_index, sharded_index)
        self.run = run
        # what the runner's log and the tests read
        self.device, self.use_device = run.device, run.use_device
        self.device_seed, self.sharded_index = run.device_seed, run.sharded_index
        self._ref_codes = run.genomes(self.engine) if run.use_device else None
        self._next_dev = 0  # dispatches to a list of more than one entry
        self.dispatched = [0] * len(run.devices)  # extend batches an entry
        self.streams = {}  # a mapping thread's stream a card (stream_context)
        # the devices are all cards or all the CPU (check_devices): the extend
        # takes the native enqueue, or the plain chain
        self._on_card = self.device.type == "cuda"
        self._index = index
        self._params = index_parameters
        self._map_param = map_param
        self.host_seeded = 0  # records the engine seeded itself
        self.host_walked = 0  # records whose runs the engine walked on the host index
        self.shard_lookup_s = 0.0  # wall time of the sharded lookups
        self.rescue_preflight_s = 0.0  # and of the host's rescue preflight
        self.span_s = dict.fromkeys(SPAN_TIMERS, 0.0)
        self.counts = dict.fromkeys(EXTEND_COUNTERS, 0)

    SEED_L = 256  # longest read seeded on the device (longer: host)

    @staticmethod
    def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(a)
        if device.type != "cuda":
            return host
        return host.pin_memory().to(device, non_blocking=True)

    def _preseed(self, fx, n_records: int, chunk_index: int):
        """Phase A of one reader chunk with its seeds, index hits and run
        walk from the device: the chunk's codes go up, `seed_and_find`
        seeds, compacts and looks them up there into one buffer,
        `walk_hits_compact` walks the found strobes' runs (the repetitive
        filter at the index's cutoff, every run it passes walked whole)
        into a second, and both come back into pinned memory behind one
        wait (counts[i] = -1: the engine seeds record i itself; a record
        whose hits overflow its room of one a strobe is walked on the
        host). The seeding, from the codes' export to the arrays on the
        host, is the span ``rsb.seed#<chunk>`` (`device_seed_s`). Returns
        the chunk, the records the engine seeds itself and those whose
        runs it walks on the host."""
        with Span(self.span_s, "device_seed_s", "seed", chunk_index):
            codes, lens = self.engine.fx_codes(fx, n_records, self.SEED_L)
            sp, rp = self._params.syncmer, self._params.randstrobe
            ix_hashes, buckets, ix_pos, ix_packed = self.run.seed_index
            buf, total = seed_and_find(self._upload(codes, self.device),
                                       self._upload(lens, self.device), ix_hashes, buckets,
                                       sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q,
                                       rp.max_dist, self.SEED_L, self._index.bits)
            cutoff = int(self._index.filter_cutoff)
            # a run that passes the filter has at most `cutoff` rows
            walk = walk_hits_compact(*strobe_views(buf, n_records, total), ix_hashes, ix_pos,
                                     ix_packed, sp.k, cutoff, cutoff)
            if buf.device.type == "cuda":  # the chunk's arrays back in two copies
                host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                        for x in (buf, walk)]
                for h, x in zip(host, (buf, walk)):
                    h.copy_(x, non_blocking=True)
                torch.cuda.current_stream(buf.device).synchronize()
                buf, walk = host
            counts, offsets, hashes, starts, ends, is_rev, positions = (
                x.numpy() for x in strobe_views(buf, n_records, total))
            walked = [x.numpy() for x in walk_views(walk, n_records, total)]
            n_host = int((counts < 0).sum())
        chunk = self.engine.chunk_a_fx_pre(
            fx, chunk_index, counts, offsets, _at_least_one(hashes.view(np.uint64)),
            *map(_at_least_one, (starts, ends, is_rev, positions)),
            walk=[_at_least_one(x) for x in walked])
        return chunk, n_host, n_host + int(walked[4].sum())

    def _shard_chunk_a(self, fx, n_records: int, chunk_index: int):
        """Phase A with every index lookup served by the sharded index:
        host seeding (no index access) -> one batched lookup, compacted on
        the device into the run records the engine walks -> host preflight
        of the rescue take-rule (it depends only on per-strobe counts,
        which the first lookup returned) -> a second capped lookup for
        exactly the strobes rescue will walk -> engine RunFeed. Counters:
        engine feed_miss must stay 0."""
        eng = self.engine
        si = self.sharded_index
        h, total = eng.fx_seed_only(fx)
        counts, offsets, hashes, starts, ends, rev = eng.fx_seed_copy(h, n_records, total)
        t0 = time.perf_counter()
        if total:
            res = si.find_runs_compact(hashes)
            cnt, filt, run_off = res["count"], res["filtered"], res["run_off"]
            run_pos, run_packed = res["run_positions"], res["run_packed"]
        else:
            cnt = np.zeros(0, np.int64)
            filt = np.zeros(0, bool)
            run_off = np.full(1, -1, np.int64)
            run_pos = np.zeros(1, np.uint32)
            run_packed = np.zeros(1, np.uint32)
        walk = (cnt > 0) & ~filt
        t1 = time.perf_counter()
        self.shard_lookup_s += t1 - t0

        # rescue preflight: the engine rescues when nams are empty or the
        # float32 nonrepetitive fraction compares < 0.7f — and with run
        # feeds, nams are empty iff no unfiltered hit exists
        resc_off = np.full(max(total, 1), -1, np.int64)
        resc_pos = np.zeros(1, np.uint32)
        resc_packed = np.zeros(1, np.uint32)
        if total and self._map_param.rescue_level > 1:
            read_id = np.repeat(np.arange(n_records),
                                np.diff(offsets).astype(np.int64))
            found = cnt > 0
            tot_r = np.bincount(read_id[found], minlength=n_records)
            good_r = np.bincount(read_id[walk], minlength=n_records)
            frac = np.ones(n_records, np.float32)
            nz = tot_r > 0
            frac[nz] = (good_r[nz].astype(np.float32)
                        / tot_r[nz].astype(np.float32))
            rescue = (good_r == 0) | (frac < np.float32(0.7))
            cutoff = int(self._map_param.rescue_cutoff)
            sel_parts = []
            for r in np.flatnonzero(rescue):
                lo, hi = int(offsets[r]), int(offsets[r + 1])
                gi0 = np.arange(lo, hi)
                gi0 = gi0[cnt[lo:hi] > 0]
                if gi0.size == 0:
                    continue
                for orient in (0, 1):
                    g = gi0[rev[gi0] == orient]
                    if g.size == 0:
                        continue
                    order = np.lexsort((ends[g], starts[g], cnt[g]))
                    g = g[order]
                    c = cnt[g]
                    n0 = int((c <= cutoff).sum())
                    if n0 >= 5:
                        # strobes past RESCUE_RUN_CAP are never consumed,
                        # also when -R pushes the cutoff past it
                        take = g[: int((c <= min(cutoff, RESCUE_RUN_CAP)).sum())]
                    else:
                        ok = g[c <= RESCUE_RUN_CAP]
                        k = min(len(ok), 5)
                        if 0 < k < len(ok):
                            # the take-rule's 5-hit budget can land inside
                            # a (count, qs, qe) tie class whose member
                            # order is the unstable introsort's choice —
                            # feed the whole class so any member works
                            bq = (cnt[ok[k - 1]], starts[ok[k - 1]],
                                  ends[ok[k - 1]])
                            while (k < len(ok)
                                   and (cnt[ok[k]], starts[ok[k]],
                                        ends[ok[k]]) == bq):
                                k += 1
                        take = ok[:k]
                    if take.size:
                        sel_parts.append(take)
            if sel_parts:
                # strobe ranges are disjoint per read, so sel is unique; no
                # selected count is above RESCUE_RUN_CAP: all are walked
                sel = np.concatenate(sel_parts)
                t2 = time.perf_counter()
                r2 = si.find_runs_compact(hashes[sel], RESCUE_RUN_CAP)
                resc_off[sel] = r2["run_off"]
                resc_pos, resc_packed = r2["run_positions"], r2["run_packed"]
                second = time.perf_counter() - t2  # the lookup's, not the preflight's
                self.shard_lookup_s += second
                t1 += second
        self.rescue_preflight_s += time.perf_counter() - t1

        return eng.chunk_a_fx_runs(
            fx, chunk_index, counts, offsets, _at_least_one(hashes), starts, ends, rev,
            np.ascontiguousarray(cnt, dtype=np.int64) if total else np.zeros(1, np.int64),
            np.ascontiguousarray(filt, dtype=np.uint8) if total else np.zeros(1, np.uint8),
            run_off, run_pos, run_packed, resc_off, resc_pos, resc_packed,
        )

    def _dispatch(self, buf: np.ndarray, Q: int, T: int, sub: int):
        """Extend one q2 batch on the next device (round-robin) against
        that device's genome. On a card (`buf` then the `q2_staging` view
        that `_plan_and_dispatch` filled): one native enqueue of the
        upload, the q2 forward, the packed traceback and the copy back on
        the thread's stream, behind one event. On the CPU: the plain chain.
        Returns (packed output (OUT_ROWS, B) u8 on the host, event); the
        event is None on the CPU, where the output is ready."""
        devices = self.run.devices
        di = 0
        if len(devices) > 1:
            di = self._next_dev % len(devices)
            self._next_dev += 1
        self.dispatched[di] += 1
        dev = devices[di]
        if not self._on_card:
            out = extend_batch_packed_resident_q2(self._upload(buf, dev), self._ref_codes[di], Q,
                                                  T, self.run.sw, sub)
            return out.numpy(), None
        out = extend_q2_enqueue(buf, self._ref_codes[di], Q, T, self.run.sw)
        self.counts["native_batches"] += 1
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return out, event

    def _plan_and_dispatch(self, chunk, chunk_index: int) -> list:
        """The extend of a chunk after its phase A: plan, q2 fill (on a
        card into a new pinned block), upload, launches and the copy back
        enqueued, batch by batch; counts the chunk and each batch's live
        jobs, DP cells (query length x target window length) and upload
        bytes."""
        pending = []
        counts = self.counts
        with Span(self.span_s, "dispatch_s", "dispatch", chunk_index):
            counts["chunks"] += 1
            if self.use_device and chunk.n_jobs:
                for idxs, Q, T, B, sub in self.engine.plan_batches(chunk, self.batch_size):
                    buf = self.engine.fill_batch_q2(chunk, idxs, B, Q,
                                                    q2_staging(Q, B) if self._on_card else None)
                    counts["device_jobs"] += len(idxs)
                    counts["device_cells"] += int(np.dot(chunk.qlens[idxs].astype(np.int64),
                                                         chunk.tlens[idxs]))
                    counts["upload_bytes"] += buf.nbytes
                    out, event = self._dispatch(buf, Q, T, sub)
                    pending.append((idxs, out, event, Q + T - 1))
        return pending

    def _start(self, chunk_index: int, n_records: int, fx=None, reader=None, records=None):
        """Phase A of a chunk, then its extend dispatched; returns the
        state `finish_chunk` takes. Phase A takes the Python `records`
        (r1, r2, r3), seeded on the host, or the reader chunk `fx` (its
        buffer back to `reader`'s pool) with its lookups served by the
        sharded index under --shard-index, seeded and looked up on the
        device where `device_seed`, else all on the host. Where it chooses,
        it counts the records the engine seeds (`host_seeded`) and whose
        runs it walks (`host_walked`) on the host."""
        seeded = walked = n_records
        with Span(self.span_s, None, "phase_a", chunk_index):
            try:
                if records is not None:
                    chunk = self.engine.chunk_a(*records, chunk_index)
                elif self.device_seed:
                    chunk, seeded, walked = self._preseed(fx, n_records, chunk_index)
                elif self.run.shard_index:
                    chunk = self._shard_chunk_a(fx, n_records, chunk_index)
                else:
                    chunk = self.engine.chunk_a_fx(fx, chunk_index)
            finally:
                if reader is not None:
                    reader.free_chunk(fx)  # pooled buffer must always return
        self.host_seeded += seeded
        self.host_walked += walked
        return chunk, self._plan_and_dispatch(chunk, chunk_index), chunk_index

    # --- two-phase API (callers drive the cross-chunk pipelining) -------

    def start_chunk(self, records1, records2, records3, chunk_index: int):
        """Phase A (host seeding) + async device dispatch; returns an
        opaque state."""
        return self._start(chunk_index, len(records1) + len(records2) + len(records3),
                           records=(records1, records2, records3))

    def finish_chunk(self, state) -> bytes:
        """Wait for the chunk's device results, then phase B; returns the
        output bytes (SAM/PAF text is ASCII; writers are binary). Each
        batch is waited for (a `device_wait` span a batch, inside
        `phase_b`) and its results taken in turn, so taking one batch's
        results overlaps the card's work on the next."""
        chunk, pending, chunk_index = state
        span_s = self.span_s
        with Span(span_s, None, "phase_b", chunk_index):
            for idxs, out, event, D in pending:
                with Span(span_s, "device_wait_s", "device_wait", chunk_index):
                    if event is not None:
                        event.synchronize()
                t0 = time.perf_counter()
                self.engine.set_device_results(chunk, out, D, idxs)
                span_s["device_results_s"] += time.perf_counter() - t0
            return self.engine.chunk_b_bytes(chunk)

    def _pipelined(self, started: Iterator, depth: int, emit, t0: float) -> None:
        """The software pipelining of every mapping loop: take the next
        started chunk from `started` (a generator, so the chunk's phase A
        and dispatch run as it is taken) and, while more than `depth` are
        in flight, finish the oldest (phase B) and emit(chunk index,
        bytes) it; then finish the rest in order. The mapping thread's
        seconds since `t0` go to `worker_s`."""
        in_flight = deque()

        def finish_emit():
            state = in_flight.popleft()
            text = self.finish_chunk(state)
            with Span(self.span_s, "emit_s", "emit", state[2]):
                emit(state[2], text)

        try:
            for state in started:
                in_flight.append(state)
                if len(in_flight) > depth:
                    finish_emit()
            while in_flight:
                finish_emit()
        finally:
            self.span_s["worker_s"] += time.perf_counter() - t0

    def map_all(
        self,
        chunks: Iterable[Tuple[int, list, list, list]],
        write: Callable[[bytes], None],
        depth: int = 3,
    ) -> int:
        """Software-pipelined mapping over (index, r1, r2, r3) chunks with
        up to `depth` chunks in flight; returns reads mapped. Phase B of
        chunk i runs after phase A of chunks i+1..i+depth, so the
        insert-size estimator trails by `depth` chunks, as the
        reference's overlapped workers do."""
        t0 = time.perf_counter()
        boost_mapping_thread()
        n_reads = 0

        def started():
            nonlocal n_reads
            for chunk_index, r1, r2, r3 in chunks:
                n_reads += len(r1) + len(r2) + len(r3)
                yield self.start_chunk(r1, r2, r3, chunk_index)

        self._pipelined(started(), depth, lambda ci, text: write(text), t0)
        return n_reads

    def map_file(self, path1, path2, interleaved, chunk_size, write,
                 depth: int = 3, progress=None) -> int:
        """Fully native input path: the C++ reader parses chunks, phase A
        consumes them zero-copy, the device extends, phase B writes
        output. Returns the number of reads mapped. `progress(n_reads)`
        is called after every chunk when given."""
        return self._map_chunks(path1, path2, interleaved, chunk_size,
                                lambda ci, text: write(text), depth, progress)

    def map_file_sharded(self, path1, path2, interleaved, chunk_size, shard_writer,
                         process_index: int, process_count: int, depth: int = 3) -> int:
        """One pod host's share of map_file: every host parses the whole
        stream (cheap next to mapping) but maps only the chunks with
        index % process_count == process_index, writing (chunk index,
        bytes) to its `ShardWriter` for node 0's merge into chunk order.
        Returns the number of reads this host mapped."""
        return self._map_chunks(path1, path2, interleaved, chunk_size,
                                shard_writer.write_chunk, depth,
                                owns=lambda ci: ci % process_count == process_index)

    def _map_chunks(self, path1, path2, interleaved, chunk_size, emit, depth: int,
                    progress=None, owns=None) -> int:
        """Map the chunks of the native reader that `owns` accepts (all
        without it) with up to `depth` in flight, calling emit(chunk
        index, bytes) in chunk order. The thread is boosted before the
        reader starts its producer thread, which inherits the priority."""
        t0 = time.perf_counter()
        boost_mapping_thread()
        reader = NativeReader(path1, path2, interleaved, chunk_size)
        n_reads = 0

        def started():
            nonlocal n_reads
            chunks = iter(reader)
            while True:
                with Span(self.span_s, "read_wait_s", "read"):
                    item = next(chunks, None)
                if item is None:
                    return
                chunk_index, fx, n_pairs, n_singles = item
                if owns is not None and not owns(chunk_index):
                    reader.free_chunk(fx)
                    continue
                n_reads += 2 * n_pairs + n_singles
                if progress is not None:
                    progress(n_reads)
                yield self._start(chunk_index, 2 * n_pairs + n_singles, fx, reader)

        try:
            self._pipelined(started(), depth, emit, t0)
        finally:
            reader.close()
        return n_reads

    def counters(self) -> dict:
        """The engine's counters, then the pipeline's: the records the
        engine seeded on the host (every record, or where seeding runs on
        the device its tie and long reads), the records whose runs it
        walked on the host (those, and where the device walks the runs the
        records whose hits overflowed their room), chunks, the extend's jobs, DP
        cells and upload bytes, the planned jobs left to the host (no
        bucket fits them, or a batch under MIN_DEVICE_JOBS), the jobs
        planned into the read-length profile's tight bucket
        (`engine_buckets(r)[0]`; 0 where the engine has none) and every
        job `plan_batches` saw."""
        shapes = self.engine.job_shapes()
        per_bucket = [n for _, _, n in shapes["buckets"]]
        tight = per_bucket[0] if self.engine.buckets[0] not in ENGINE_BUCKETS else 0
        return {**self.engine.counters(), "host_seeded": self.host_seeded,
                "host_walked": self.host_walked, **self.counts,
                "small_to_host": shapes["small_to_host"], "unbucketed": shapes["unbucketed"],
                "tight_jobs": tight, "planned_jobs": sum(per_bucket) + shapes["unbucketed"]}

    def dispatches(self) -> list:
        """Extend batches dispatched to each entry of the device list."""
        return list(self.dispatched)

    def timers(self) -> dict:
        return {**self.engine.timers(), "shard_lookup_s": self.shard_lookup_s,
                "rescue_preflight_s": self.rescue_preflight_s, **self.span_s}

    @contextlib.contextmanager
    def stream_context(self):
        """Enter on a mapping thread: a CUDA stream of its own on each of
        the run's `cards` (the current stream is per thread and card, so
        workers that shared a card's default stream would serialize their
        kernels there), with the first card current; nothing without
        cards. `streams` keeps the last context's streams by card."""
        if not self.run.cards:
            yield
            return
        with contextlib.ExitStack() as stack:
            self.streams = {d: torch.cuda.Stream(d) for d in self.run.cards}
            for stream in self.streams.values():
                stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.cuda.device(self.device))
            yield


def native_pipeline_available() -> bool:
    """`engine_available`: false only under RABBITSALIGN_TPU_NO_NATIVE; a
    failed engine build raises."""
    return engine_available()


class DevicePrewarm(threading.Thread):
    """The device prewarm of `prewarm_device`. It keeps its exception:
    `result()` joins the thread and re-raises it, so a kernel library
    that does not build, a card that is absent, or a probe that does not
    launch, fails the run before any output is written."""

    def __init__(self, device: torch.device):
        super().__init__(name="device-prewarm")
        self.device = device
        self.error: Optional[BaseException] = None
        self.probe_ok: Optional[bool] = None

    def run(self) -> None:
        try:
            self.probe_ok = _warm_device(local_devices(self.device))
        except Exception as e:  # re-raised by result() on the caller's thread
            self.error = e

    def result(self) -> Optional[bool]:
        """Wait for the prewarm; the int16 probe's answer (None on the
        CPU), or the prewarm's exception."""
        self.join()
        if self.error is not None:
            raise self.error
        return self.probe_ok


def _warm_device(devices) -> Optional[bool]:
    """Build or load the kernel library, create the CUDA context on every
    card of the device list and run the int16 probe on the first, as the
    JAX prewarm probes its default device. The CPU has nothing to build
    or probe."""
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if not cards:
        return None
    from ..ops.cuda_build import load_kernels
    from ..ops.int16_probe import probe_int16_lowering

    load_kernels()
    torch.cuda.init()
    for card in cards:
        torch.empty(1, device=card)  # the card's context, made here
        torch.cuda.synchronize(card)
    with torch.cuda.device(cards[0]):
        return probe_int16_lowering(cards[0])


def prewarm_device(device) -> DevicePrewarm:
    """Start the device prewarm in a background thread, so the one-off
    kernel build, the cards' CUDA contexts and the probe overlap
    reference and index loading (the counterpart of rabbitsalign_tpu's
    prewarm_extend_programs, which compiles the extend programs and runs
    its probe there) on `local_devices(device)`, the pipelines' default
    list. Call `result()` before the first chunk is mapped."""
    t = DevicePrewarm(torch.device(device))
    t.start()
    return t


class ThreadedNativePipeline:
    """N-worker chunk mapping — the reference's consumer-thread data
    parallelism (reference src/main.cpp:453-592 worker spawn, src/pc.cpp
    InputBuffer/OutputBuffer): the native reader feeds a bounded queue,
    each worker owns a NativePipeline (its own engine, so its own
    insert-size estimator and statistics, like the reference's per-thread
    state) and processes whole chunks; output is reordered by chunk index
    before writing. Engine calls, CUDA event waits and kernel launches
    release the GIL, so workers scale on multicore hosts. Each worker
    dispatches on a CUDA stream of its own and double-buffers: the device
    extends its chunk i while it runs phase A of chunk i+1.

    Like the reference, PE output depends on which worker handled which
    chunk (insert-size history); SE output is identical for any worker
    count. With ``deterministic=True`` chunks are handed out round-robin
    (worker w gets chunk indices w, w+N, w+2N, ...) instead of
    first-free-worker, which makes PE output a pure function of
    (input, n_workers), at the cost of head-of-line blocking when chunk
    costs are skewed.
    """

    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        use_device: bool = True,
        batch_size: int = 1024,
        n_workers: int = 3,
        queue_depth: int = 8,
        device="cuda",
        deterministic: bool = False,
        device_seed: bool = False,
        shard_index: bool = False,
        pin_workers: bool = False,
        devices=None,
    ):
        # one run for every worker, made here, in set-up: one sharded
        # index (each worker looks up on its own streams), one seed index
        # and one genome a distinct device
        self.run = DeviceRun(index, aln_params, use_device, device, devices, device_seed,
                             shard_index)
        self.device_seed, self.sharded_index = self.run.device_seed, self.run.sharded_index
        self._mk = lambda: NativePipeline(
            index, index_parameters, references, aln_params, map_param,
            read_group_id, batch_size=batch_size, run=self.run,
        )
        self.n_workers = max(1, n_workers)
        self.queue_depth = queue_depth
        self.deterministic = deterministic
        self.pin_workers = pin_workers
        self.pinned_cpus = []  # (wid, cpu) telemetry, filled by workers
        self._counters = []
        self._timers = []
        self._main_s = dict.fromkeys(SPAN_TIMERS, 0.0)  # the reading thread's spans
        self.worker_dispatched = []  # each worker's extend batches an entry

    def map_file(self, path1, path2, interleaved, chunk_size, write,
                 progress=None) -> int:
        # per-run telemetry: a reused pipeline object must not report
        # the previous map_file call's counters twice
        self._counters = []
        self._timers = []
        self._main_s = main_s = dict.fromkeys(SPAN_TIMERS, 0.0)
        self.worker_dispatched = []

        # deterministic mode: one queue per worker, chunks routed by
        # index % n_workers; default: one shared queue, first free worker
        if self.deterministic:
            in_qs = [queue.Queue(maxsize=max(2, self.queue_depth // self.n_workers))
                     for _ in range(self.n_workers)]
        else:
            in_qs = [queue.Queue(maxsize=self.queue_depth)]
        out_lock = threading.Condition()
        out_buf = {}
        next_out = [0]
        n_reads = 0
        errors = []

        def emit(ci, text):
            with out_lock:
                out_buf[ci] = text
                while next_out[0] in out_buf:
                    write(out_buf.pop(next_out[0]))
                    next_out[0] += 1
                out_lock.notify_all()

        def worker(wid):
            t0 = time.perf_counter()
            own = dict.fromkeys(("worker_setup_s", "input_wait_s"), 0.0)
            if self.pin_workers:
                cpu = pin_worker_thread(wid)
                if cpu is not None:
                    self.pinned_cpus.append((wid, cpu))
            boost_mapping_thread()
            in_q = in_qs[wid % len(in_qs)]
            pipe = None

            def started():
                while True:
                    with Span(own, "input_wait_s", "input_wait"):
                        item = in_q.get()
                    if item is None:
                        return
                    ci, fx, n_records = item
                    yield pipe._start(ci, n_records, fx, reader)

            try:
                with contextlib.ExitStack() as stack:
                    # inside the try: a construction failure (device OOM,
                    # no device) must reach `errors`, or the producer's
                    # bounded put would retry forever against a dead worker
                    with Span(own, "worker_setup_s", "setup"):
                        pipe = self._mk()
                        stack.enter_context(pipe.stream_context())
                    # double buffering: the card extends chunk i while
                    # phase A of chunk i+1 runs
                    pipe._pipelined(started(), 1, emit, t0)
            except Exception as e:  # propagated to the caller by map_file
                errors.append(e)
                with out_lock:
                    out_lock.notify_all()
            finally:
                if pipe is not None:
                    self._counters.append(pipe.counters())
                    self._timers.append(_summed([pipe.timers(), own]))
                    self.worker_dispatched.append(pipe.dispatched)

        reader = NativeReader(path1, path2, interleaved, chunk_size)
        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"mapping-worker-{w}")
                   for w in range(self.n_workers)]
        for t in threads:
            t.start()
        chunks = iter(reader)
        try:
            while True:
                with Span(main_s, "read_wait_s", "read"):
                    item = next(chunks, None)
                if item is None:
                    break
                ci, fx, np_, ns = item
                n_reads += 2 * np_ + ns
                if progress is not None:
                    progress(n_reads)
                q_i = ci % len(in_qs)
                # bounded put that cannot deadlock if all workers died
                with Span(main_s, "handoff_wait_s", "handoff"):
                    while True:
                        if errors:
                            reader.free_chunk(fx)
                            break
                        try:
                            in_qs[q_i].put((ci, fx, 2 * np_ + ns), timeout=1.0)
                            break
                        except queue.Full:
                            continue
                if errors:
                    break
        finally:
            if self.deterministic:
                # one private queue per worker: the sentinel can only be
                # consumed by its owner, so a per-worker alive check is safe
                for w in range(self.n_workers):
                    while threads[w].is_alive():
                        try:
                            in_qs[w].put(None, timeout=1.0)
                            break
                        except queue.Full:
                            continue
            else:
                # shared queue: ANY worker can consume ANY sentinel, so a
                # per-worker alive check races (a worker that eats a
                # sentinel posted "for" another one and exits leaves a
                # live worker blocked in get() forever with its buffered
                # chunk unflushed). Post as many sentinels as workers
                # were alive at one snapshot.
                n_alive = sum(t.is_alive() for t in threads)
                posted = 0
                while posted < n_alive:
                    try:
                        in_qs[0].put(None, timeout=1.0)
                        posted += 1
                    except queue.Full:
                        if not any(t.is_alive() for t in threads):
                            break
            for t in threads:
                if errors:
                    # a failed run salvages what it can but must not hang
                    t.join(timeout=60.0)
                else:
                    # healthy workers always exit once their sentinel
                    # arrives; a bounded join would drop the last chunk
                    # of a worker still waiting on its device results
                    t.join()
            reader.close()
        if errors:
            raise errors[0]
        # flush any leftover ordered output (all chunks are in out_buf now)
        for ci in sorted(out_buf):
            write(out_buf.pop(ci))
        return n_reads

    def dispatches(self) -> list:
        """Extend batches dispatched to each entry of the device list,
        summed over the workers."""
        return [sum(col) for col in zip(*self.worker_dispatched)]

    def counters(self) -> dict:
        """The workers' counters, summed."""
        return _summed(self._counters)

    def timers(self) -> dict:
        """The workers' timers and the reading thread's waits, summed:
        thread-seconds."""
        return _summed([*self._timers, self._main_s])
