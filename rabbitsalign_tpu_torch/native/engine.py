"""ctypes wrapper around the native mapping engine (engine.cpp).

`NativeEngine` owns an engine handle (index + references + parameters +
persistent insert-size/statistics state); `chunk_a` runs phase A for one
chunk of reads (seeding, NAM chaining, mapping decisions, Hamming fast
path) and returns a `NativeChunk` carrying the pending gapped-extension
jobs; the caller dispatches those to the GPU in fixed-shape buckets
(`fill_batch_q2` packs the device input buffer natively) and feeds the raw
device outputs back via `set_device_results`; `chunk_b` finishes
pairing/rescue/mapq and SAM or PAF formatting and returns the output
text. Jobs without device results (no bucket, failed validation) are
re-aligned natively with the built-in SSW — the reference's `gasal_fail`
CPU fallback (reference src/pc.cpp:446-478).

All calls release the GIL, so chunks can be processed on worker threads.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import load_engine, native_disabled

# (Q, T, kernel B, dispatch groups) device buckets, the same geometry as
# rabbitsalign_tpu/native/engine.py so both packages plan identical
# batches (and the engine's outputs stay comparable byte for byte). The
# reference runs fixed 512-pair batches (src/gasal2_ssw.h:22).
# `groups` kernel batches share one dispatch (one transfer each way).
ENGINE_BUCKETS: Tuple[Tuple[int, int, int, int], ...] = (
    (256, 512, 512, 4),
    (256, 1536, 512, 1),
    (512, 2048, 512, 1),
)


def engine_buckets(r: int = 150) -> Tuple[Tuple[int, int, int, int], ...]:
    """Bucket geometry derived from the read-length profile. Extend
    windows are the NAM projection +-50 bp (reference src/
    aln.cpp:468-473), so tlen <= qlen + ~105 by construction and a tight
    (Q0, T0) rectangle holds the high-volume jobs — for r=150 the
    (152, 256) bucket. Jobs that exceed it (indel drift, long reads in a
    short-profile run, rescue windows) fall through to the legacy
    buckets. ``RSB_TIGHT_GROUPS`` (a power of two up to 16, default 2)
    sets how many tight batches share one dispatch."""
    q0 = int(min(256, max(64, ((int(r) + 2 + 7) // 8) * 8)))
    t0 = int(min(512, ((q0 + 104 + 7) // 8) * 8))
    bcap = 1024 if q0 <= 160 else 512
    import os

    try:
        tg = int(os.environ.get("RSB_TIGHT_GROUPS", "2"))
    except ValueError:
        tg = 2
    # the planner quantizes to pow2 group widths; a bad env value
    # degrades to the default instead of crashing plan_batches
    if tg < 1 or (tg & (tg - 1)) != 0 or tg > 16:
        tg = 2
    tight = ((q0, t0, bcap, tg),) if (q0, t0) != (256, 512) else ()
    return tight + ENGINE_BUCKETS


def _lib():
    lib = load_engine()
    if not getattr(lib, "_engine_configured", False):
        c = ctypes
        lib.engine_create.restype = c.c_void_p
        lib.engine_create.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # index arrays
            c.c_uint64, c.c_int, c.c_uint32,                 # n, bits, cutoff
            c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,     # k s t wmin wmax
            c.c_uint64, c.c_int,                             # qmask max_dist
            c.c_uint32, c.c_int,                             # rescue cutoff/level
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,  # refs
            c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,     # A B O E L
            c.c_double, c.c_int64, c.c_int64, c.c_int,       # dropoff tries sec sam
            c.c_int, c.c_int, c.c_int, c.c_char_p,           # eqx unmapped det rg
            c.c_int,                                         # pe_ref_async
        ]
        lib.engine_free.argtypes = [c.c_void_p]
        lib.engine_counters.argtypes = [c.c_void_p, c.c_void_p]
        lib.engine_timers.argtypes = [c.c_void_p, c.c_void_p]
        lib.engine_isize.argtypes = [c.c_void_p, c.c_void_p]
        lib.engine_chunk_a.restype = c.c_void_p
        lib.engine_chunk_a.argtypes = [
            c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_int64, c.c_uint64,
        ]
        lib.chunk_n_jobs.restype = c.c_int64
        lib.chunk_n_jobs.argtypes = [c.c_void_p]
        lib.chunk_job_lens.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
        lib.chunk_fill_batch.argtypes = [
            c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
            c.c_void_p,
        ]
        lib.chunk_fill_batch_q.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
            c.c_int64, c.c_void_p,
        ]
        lib.chunk_fill_batch_q2.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
            c.c_int64, c.c_void_p,
        ]
        lib.chunk_set_device_results.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
            c.c_void_p, c.c_int64,
        ]
        lib.engine_chunk_b.argtypes = [c.c_void_p, c.c_void_p]
        lib.chunk_out_len.restype = c.c_int64
        lib.chunk_out_len.argtypes = [c.c_void_p]
        lib.chunk_out_copy.argtypes = [c.c_void_p, c.c_void_p]
        lib.chunk_free.argtypes = [c.c_void_p]
        # native chunked FASTQ/FASTA reader
        lib.fastx_open.restype = c.c_void_p
        lib.fastx_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int, c.c_int64]
        lib.fastx_next.restype = c.c_void_p
        lib.fastx_next.argtypes = [c.c_void_p]
        lib.fastx_error.restype = c.c_int
        lib.fastx_error.argtypes = [c.c_void_p]
        lib.fastx_counts.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
        lib.fastx_chunk_free.argtypes = [c.c_void_p]
        lib.fastx_close.argtypes = [c.c_void_p]
        # async producer-thread reader (RabbitFX DataPool parity)
        lib.fastx_open_async.restype = c.c_void_p
        lib.fastx_open_async.argtypes = [c.c_char_p, c.c_char_p, c.c_int,
                                         c.c_int64, c.c_int64]
        lib.fastx_next_async.restype = c.c_void_p
        lib.fastx_next_async.argtypes = [c.c_void_p]
        lib.fastx_release_async.argtypes = [c.c_void_p, c.c_void_p]
        lib.fastx_error_async.restype = c.c_int
        lib.fastx_error_async.argtypes = [c.c_void_p]
        lib.fastx_close_async.argtypes = [c.c_void_p]
        lib.engine_chunk_a_fx.restype = c.c_void_p
        lib.engine_chunk_a_fx.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64]
        # --device-seed: code export for the seeding kernels, and phase A
        # from their (compacted) results
        lib.fx_chunk_codes.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                       c.c_void_p, c.c_int64]
        lib.engine_chunk_a_fx_pre.restype = c.c_void_p
        lib.engine_chunk_a_fx_pre.argtypes = [
            c.c_void_p, c.c_void_p, c.c_uint64,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p,
        ]
        # --shard-index: host seeding without the index, and phase A from
        # the sharded index's run records
        lib.engine_fx_seed_only.restype = c.c_void_p
        lib.engine_fx_seed_only.argtypes = [c.c_void_p, c.c_void_p]
        lib.seedonly_total.restype = c.c_int64
        lib.seedonly_total.argtypes = [c.c_void_p]
        lib.seedonly_copy.argtypes = [c.c_void_p] + [c.c_void_p] * 6
        lib.seedonly_free.argtypes = [c.c_void_p]
        lib.engine_chunk_a_fx_runs.restype = c.c_void_p
        lib.engine_chunk_a_fx_runs.argtypes = ([c.c_void_p, c.c_void_p, c.c_uint64]
                                               + [c.c_void_p] * 14)
        lib._engine_configured = True
    return lib


def engine_available() -> bool:
    """Whether the engine can be used: false only under
    RABBITSALIGN_TPU_NO_NATIVE. Otherwise the engine is loaded (built if
    need be), and a build that fails raises, as `load_engine` does."""
    if native_disabled():
        return False
    _lib()
    return True


def _offsets(items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(items) + 1, dtype=np.int64)
    for i, b in enumerate(items):
        off[i + 1] = off[i] + len(b)
    blob = b"".join(items)
    arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    return arr, off


class NativeChunk:
    __slots__ = ("handle", "n_jobs", "qlens", "tlens", "lib", "closed")

    def __init__(self, lib, handle: int):
        self.lib = lib
        self.handle = handle
        self.closed = False
        self.n_jobs = int(lib.chunk_n_jobs(handle))
        self.qlens = np.zeros(max(self.n_jobs, 1), dtype=np.int32)
        self.tlens = np.zeros(max(self.n_jobs, 1), dtype=np.int32)
        if self.n_jobs:
            lib.chunk_job_lens(handle, self.qlens.ctypes.data, self.tlens.ctypes.data)

    def free(self) -> None:
        if not self.closed:
            self.lib.chunk_free(self.handle)
            self.closed = True

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.free()
        except Exception:
            pass


class NativeEngine:
    """One engine instance per worker (its insert-size estimator and
    statistics are per-worker, like the reference's per-thread state)."""

    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        buckets: Optional[Tuple[Tuple[int, int, int, int], ...]] = None,
    ):
        self.lib = lib = _lib()
        # bucket geometry follows the run's read-length profile (tight
        # high-volume bucket; see engine_buckets)
        self.buckets = (buckets if buckets is not None
                        else engine_buckets(getattr(map_param, "r", 150)))
        # job-shape telemetry (`job_shapes`): per-bucket job counts (the
        # last slot counts jobs no bucket fits, which go to the host), 32-bp
        # (qlen, tlen) histograms of every planned job, and the sub-
        # MIN_DEVICE_JOBS leftovers resolved on the host. Each worker owns
        # its engine, so these need no lock.
        self._shape_bucket = np.zeros(len(self.buckets) + 1, np.int64)
        self._shape_q = np.zeros(80, np.int64)
        self._shape_t = np.zeros(80, np.int64)
        self._shape_small = 0
        # phase B's copy of a chunk's output and the chunk's release, which
        # the engine's own timers leave out (seconds, `timers()`)
        self._chunk_out_s = 0.0
        # keep every borrowed array alive for the engine lifetime
        self._keep = []
        ref_blob, ref_off = _offsets(references.sequences)
        name_blob, name_off = _offsets([n.encode() for n in references.names])
        self._keep += [ref_blob, ref_off, name_blob, name_off, index]
        self._ref_blob = ref_blob
        sp = index_parameters.syncmer
        rp = index_parameters.randstrobe
        rg_tail = b"\n" if not read_group_id else f"\tRG:Z:{read_group_id}\n".encode()
        self.handle = lib.engine_create(
            index.hashes.ctypes.data, index.positions.ctypes.data,
            index.packed.ctypes.data, index.randstrobe_start_indices.ctypes.data,
            ctypes.c_uint64(index.hashes.shape[0]), index.bits,
            ctypes.c_uint32(index.filter_cutoff),
            sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max,
            ctypes.c_uint64(rp.q), rp.max_dist,
            ctypes.c_uint32(map_param.rescue_cutoff), map_param.rescue_level,
            ref_blob.ctypes.data, ref_off.ctypes.data,
            name_blob.ctypes.data, name_off.ctypes.data, len(references),
            aln_params.match, aln_params.mismatch, aln_params.gap_open,
            aln_params.gap_extend, aln_params.end_bonus,
            map_param.dropoff_threshold, map_param.max_tries,
            map_param.max_secondary, int(map_param.is_sam_out),
            int(map_param.cigar_eqx), int(map_param.output_unmapped),
            int(map_param.details), rg_tail,
            int(getattr(map_param, "pe_ref_async", False)),
        )

    def close(self) -> None:
        if self.handle:
            self.lib.engine_free(self.handle)
            self.handle = None

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass

    # --- phase A -------------------------------------------------------

    def chunk_a_fx(self, fx_chunk: int, chunk_seed: int) -> NativeChunk:
        """Phase A directly from a native reader chunk handle (zero-copy:
        the record blobs never surface to Python)."""
        handle = self.lib.engine_chunk_a_fx(
            self.handle, fx_chunk, ctypes.c_uint64(chunk_seed)
        )
        return NativeChunk(self.lib, handle)

    def fx_codes(self, fx_chunk: int, n_records: int, L: int):
        """Export a reader chunk's sequences as an (N, L) nt4 code batch
        (4 = N, also past the end of a read) and lengths (-1 = longer
        than L, seeded on the host) for the device seeding kernels
        (--device-seed). Rows are the records in the order phase A maps
        them: 2 * n_pairs mates, then the singles."""
        codes = np.empty((n_records, L), dtype=np.uint8)
        lens = np.empty(n_records, dtype=np.int32)
        self.lib.fx_chunk_codes(fx_chunk, L, codes.ctypes.data,
                                lens.ctypes.data, n_records)
        return codes, lens

    def chunk_a_fx_pre(self, fx_chunk: int, chunk_seed: int,
                       counts: np.ndarray, offsets: np.ndarray,
                       hashes: np.ndarray, starts: np.ndarray,
                       ends: np.ndarray, is_rev: np.ndarray,
                       positions: np.ndarray, walk) -> NativeChunk:
        """Phase A with device-computed seeding and index lookups:
        counts (N,) i32 (-1 = host seeding for that record), offsets (N,)
        i64 into the flat per-strobe arrays, which hold each record's
        strobes in host emission order (forward, then reverse): hashes
        u64, starts and ends i32, is_rev u8, positions i64 (-1 = absent).
        `walk` is the device's run walk of the chunk (ops/front_device.py
        `walk_views`: hits (T, 6) i32 at each record's strobe offset,
        n_hits, total, good (N,) i32, overflow (N,) u8), from which the
        engine builds each record's hits; for a record whose hits
        overflowed it walks the runs on the host index. Every array must
        hold at least one element."""
        walk_ptrs = [a.ctypes.data for a in walk]
        handle = self.lib.engine_chunk_a_fx_pre(
            self.handle, fx_chunk, ctypes.c_uint64(chunk_seed),
            counts.ctypes.data, offsets.ctypes.data, hashes.ctypes.data,
            starts.ctypes.data, ends.ctypes.data, is_rev.ctypes.data,
            positions.ctypes.data, *walk_ptrs,
        )
        return NativeChunk(self.lib, handle)

    def fx_seed_only(self, fx_chunk: int):
        """Host seeding (syncmers and randstrobes) of every record of a
        reader chunk, with no index access: the first half of phase A
        under --shard-index. Returns (handle, number of strobes) for
        `fx_seed_copy`."""
        h = self.lib.engine_fx_seed_only(self.handle, fx_chunk)
        return h, int(self.lib.seedonly_total(h))

    def fx_seed_copy(self, handle: int, n_records: int, total: int):
        """Copy out and free the strobes of `fx_seed_only`: (counts (N,)
        i32, offsets (N+1,) i64, hashes u64, starts i32, ends i32, rev u8),
        one entry a strobe in host emission order."""
        counts = np.zeros(n_records, dtype=np.int32)
        offsets = np.zeros(n_records + 1, dtype=np.int64)
        hashes = np.zeros(max(total, 1), dtype=np.uint64)
        starts = np.zeros(max(total, 1), dtype=np.int32)
        ends = np.zeros(max(total, 1), dtype=np.int32)
        rev = np.zeros(max(total, 1), dtype=np.uint8)
        self.lib.seedonly_copy(
            handle, counts.ctypes.data, offsets.ctypes.data,
            hashes.ctypes.data, starts.ctypes.data, ends.ctypes.data,
            rev.ctypes.data,
        )
        self.lib.seedonly_free(handle)
        return counts, offsets, hashes[:total], starts[:total], ends[:total], rev[:total]

    def chunk_a_fx_runs(self, fx_chunk: int, chunk_seed: int,
                        counts, offsets, hashes, starts, ends, is_rev,
                        count, filtered, run_off, run_pos, run_packed,
                        resc_off, resc_pos, resc_packed) -> NativeChunk:
        """Phase A with NAM building fed only by prefetched run records
        (engine.cpp RunFeed): the strobes of `fx_seed_copy`; per strobe
        count i64 (0: absent), filtered u8 and run_off i64 (-1: no
        records) into run_pos/run_packed u32; the rescue's records at
        resc_off i64 (-1: none) into resc_pos/resc_packed u32. The engine
        never reads the host index arrays for lookups here. Every array
        must hold at least one element."""
        arrs = [counts, offsets, hashes, starts, ends, is_rev, count,
                filtered, run_off, run_pos, run_packed, resc_off,
                resc_pos, resc_packed]
        handle = self.lib.engine_chunk_a_fx_runs(
            self.handle, fx_chunk, ctypes.c_uint64(chunk_seed),
            *[a.ctypes.data for a in arrs])
        return NativeChunk(self.lib, handle)

    def chunk_a(self, records1, records2, records3, chunk_seed: int) -> NativeChunk:
        """records1/records2: paired lists (or records1 = singles when
        records2 is empty); records3: extra singles. Mirrors
        pipeline/batched.py phase_a_chunk's processing order."""
        is_pe = bool(records2)
        seqs: List[bytes] = []
        names: List[bytes] = []
        quals: List[bytes] = []

        def push(rec):
            seqs.append(rec.seq)
            n = rec.name
            names.append(n if isinstance(n, bytes) else n.encode())
            quals.append(rec.qual or b"")

        n_pairs = 0
        if is_pe:
            n_pairs = len(records1)
            for r1, r2 in zip(records1, records2):
                push(r1)
                push(r2)
            singles = list(records3)
        else:
            singles = list(records1) + list(records3)
        for rec in singles:
            push(rec)

        seq_blob, seq_off = _offsets(seqs)
        name_blob, name_off = _offsets(names)
        qual_blob, qual_off = _offsets(quals)
        handle = self.lib.engine_chunk_a(
            self.handle,
            seq_blob.ctypes.data, seq_off.ctypes.data,
            name_blob.ctypes.data, name_off.ctypes.data,
            qual_blob.ctypes.data, qual_off.ctypes.data,
            n_pairs, len(singles), ctypes.c_uint64(chunk_seed),
        )
        return NativeChunk(self.lib, handle)

    # --- device round trip ----------------------------------------------

    # batches smaller than this resolve on the host instead: one device
    # round trip costs more than ~50 scalar SSW alignments on this class
    # of link (the reference pays the same trade with its CPU fallback)
    MIN_DEVICE_JOBS = 48

    def plan_batches(self, chunk: NativeChunk, batch_size: int):
        """Group jobs into (Q, T) buckets; yields (idxs, Q, T, B, sub)
        dispatches where B = sub * groups columns are filled and the
        kernel runs per `sub`-column group inside one dispatch. Jobs that
        fit no bucket — or tiny leftover batches not worth a round trip —
        resolve natively in phase B."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if chunk.n_jobs == 0:
            return []
        q = chunk.qlens[: chunk.n_jobs]
        t = chunk.tlens[: chunk.n_jobs]
        assigned = np.full(chunk.n_jobs, -1, dtype=np.int64)
        for bi, (qcap, tcap, _, _) in enumerate(self.buckets):
            mask = (assigned < 0) & (q <= qcap) & (t <= tcap) & (t <= 2000)
            assigned[mask] = bi
        self._shape_bucket += np.bincount(
            np.where(assigned < 0, len(self.buckets), assigned),
            minlength=len(self.buckets) + 1)
        self._shape_q += np.bincount(np.minimum(q // 32, 79), minlength=80)
        self._shape_t += np.bincount(np.minimum(t // 32, 79), minlength=80)
        plans = []
        for bi, (qcap, tcap, bcap, groups) in enumerate(self.buckets):
            idxs = np.flatnonzero(assigned == bi).astype(np.int64)
            sub = min(batch_size, bcap)
            bsz = sub * groups
            for start in range(0, idxs.shape[0], bsz):
                part = idxs[start : start + bsz]
                if part.shape[0] < self.MIN_DEVICE_JOBS:
                    self._shape_small += int(part.shape[0])
                    continue  # host resolves these in phase B
                # power-of-two group counts (1, 2, 4, ...): each distinct
                # batch width is a separate compiled program, so widths
                # are quantized — but only doubling, not jumping straight
                # to the full group count: a chunk's leftover batch used
                # to pad 800 jobs to 2048 columns, i.e. 60% wasted upload
                # bytes and DP cells on every partial dispatch
                n_groups = 1
                while n_groups * sub < part.shape[0]:
                    n_groups *= 2
                n_groups = min(n_groups, groups)
                plans.append((part, qcap, tcap, sub * n_groups, sub))
        return plans

    def fill_batch(self, chunk: NativeChunk, idxs: np.ndarray, B: int, Q: int, T: int) -> np.ndarray:
        """The self-contained fill, (Q + T + 4, B) u8: query codes, target
        codes (both padded with code 4), then qlen and tlen as u16 (lo, hi)
        rows; the layout of ops/extend_device.py `pack_input`."""
        buf = np.empty((Q + T + 4, B), dtype=np.uint8)
        self.lib.chunk_fill_batch(
            chunk.handle, idxs.ctypes.data, idxs.shape[0], B, Q, T,
            buf.ctypes.data,
        )
        return buf

    def fill_batch_q(self, chunk: NativeChunk, idxs: np.ndarray, B: int, Q: int) -> np.ndarray:
        """Query-only fill for the device-resident genome (targets gathered
        on the device): (Q + 8, B) u8 = query codes padded with code 4,
        qlen u16, tlen u16, the target's u32 offset into the genome."""
        buf = np.empty((Q + 8, B), dtype=np.uint8)
        self.lib.chunk_fill_batch_q(
            self.handle, chunk.handle, idxs.ctypes.data, idxs.shape[0], B, Q,
            buf.ctypes.data,
        )
        return buf

    def fill_batch_q2(self, chunk: NativeChunk, idxs: np.ndarray, B: int, Q: int,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        """2-bit-packed query fill (4 codes/byte + N-mask bitmap + u16
        lengths + u32 target offset) - the production upload layout,
        (ceil(Q/4) + ceil(Q/8) + 8, B) u8: into `out` where given (a
        C-contiguous array of that shape and dtype, such as a view of
        pinned memory), else into a new array."""
        rows = (Q + 3) // 4 + (Q + 7) // 8 + 8
        if out is None:
            buf = np.empty((rows, B), dtype=np.uint8)
        elif (out.shape != (rows, B) or out.dtype != np.uint8
              or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(f"fill_batch_q2: a writable C-contiguous ({rows}, {B}) uint8 "
                             f"array expected, got {out.shape} {out.dtype}")
        else:
            buf = out
        self.lib.chunk_fill_batch_q2(
            self.handle, chunk.handle, idxs.ctypes.data, idxs.shape[0], B, Q,
            buf.ctypes.data,
        )
        return buf

    def ref_codes(self) -> np.ndarray:
        """The concatenated reference blob as nt4 codes (uint8 0-4), for
        uploading once per device (the device-resident target source)."""
        table = np.full(256, 4, dtype=np.uint8)
        for ch_, v in ((65, 0), (67, 1), (71, 2), (84, 3)):  # A C G T
            table[ch_] = v
            table[ch_ + 32] = v
        return table[self._ref_blob]

    def set_device_results(self, chunk: NativeChunk, out: np.ndarray, D: int, idxs: np.ndarray) -> None:
        out = np.ascontiguousarray(out)
        self.lib.chunk_set_device_results(
            self.handle, chunk.handle, out.ctypes.data, out.shape[1], D,
            idxs.ctypes.data, idxs.shape[0],
        )

    # --- phase B --------------------------------------------------------

    def chunk_b_bytes(self, chunk: NativeChunk) -> bytes:
        """Finish the chunk and return the output as bytes (the
        production paths write binary; SAM/PAF are ASCII)."""
        self.lib.engine_chunk_b(self.handle, chunk.handle)
        t0 = time.perf_counter()
        n = int(self.lib.chunk_out_len(chunk.handle))
        out = np.empty(n, dtype=np.uint8)
        if n:
            self.lib.chunk_out_copy(chunk.handle, out.ctypes.data)
        chunk.free()
        text = out.tobytes()
        self._chunk_out_s += time.perf_counter() - t0
        return text

    def chunk_b(self, chunk: NativeChunk) -> str:
        return self.chunk_b_bytes(chunk).decode()

    # --- state ----------------------------------------------------------

    def counters(self) -> dict:
        out = np.zeros(7, dtype=np.int64)
        self.lib.engine_counters(self.handle, out.ctypes.data)
        return {
            "aligner_calls": int(out[0]),
            "tot_all_tried": int(out[1]),
            "inconsistent_nams": int(out[2]),
            "nam_rescue": int(out[3]),
            "tot_rescued": int(out[4]),
            "fallbacks": int(out[5]),
            "feed_miss": int(out[6]),
        }

    def job_shapes(self) -> dict:
        """The job shapes `plan_batches` has seen: per bucket (Q, T, jobs),
        the jobs no bucket fits (`unbucketed`), the sub-MIN_DEVICE_JOBS
        leftovers resolved on the host (`small_to_host`), and 32-bp
        qlen/tlen histograms of every planned job (80 bins, the last
        open-ended)."""
        return {
            "buckets": [(int(qc), int(tc), int(n)) for (qc, tc, _, _), n
                        in zip(self.buckets, self._shape_bucket)],
            "unbucketed": int(self._shape_bucket[-1]),
            "small_to_host": int(self._shape_small),
            "qlen_hist_32": self._shape_q.copy(),
            "tlen_hist_32": self._shape_t.copy(),
        }

    def isize(self) -> Tuple[float, float, float]:
        """(mu, sigma, sample_size) of the active insert-size estimator: the
        cumulative one, or under ``--pe-ref-async`` the most recent chunk's
        (`isize_per_chunk` tells which)."""
        out = np.zeros(4, dtype=np.float64)
        self.lib.engine_isize(self.handle, out.ctypes.data)
        return float(out[0]), float(out[1]), float(out[2])

    def isize_per_chunk(self) -> bool:
        """True when `isize` reports the per-chunk (``--pe-ref-async``)
        estimator rather than the cumulative one."""
        out = np.zeros(4, dtype=np.float64)
        self.lib.engine_isize(self.handle, out.ctypes.data)
        return bool(out[3])

    def timers(self) -> dict:
        """Phase wall-clock aggregates (the reference's per-thread timing
        statistics, src/aln.hpp:13-56), and `chunk_out_s`: the output's
        copy and the chunk's release in `chunk_b_bytes`, after phase B."""
        out = np.zeros(4, dtype=np.float64)
        self.lib.engine_timers(self.handle, out.ctypes.data)
        return {
            "phase_a_s": float(out[0]),
            "seed_nam_s": float(out[1]),
            "host_align_s": float(out[2]),
            "phase_b_s": float(out[3]),
            "chunk_out_s": self._chunk_out_s,
        }


class NativeReader:
    """Chunked FASTQ/FASTA reader over the native parser — the RabbitFX
    input layer equivalent. Iterates raw chunk handles consumed by
    NativeEngine.chunk_a_fx; each handle must be freed (free_chunk) after
    phase A has copied the records.

    By default a dedicated native PRODUCER THREAD parses and
    gz-decompresses chunks into a fixed pool of reusable buffers (the
    RabbitFX DataPool/TDataQueue design, reference RabbitFX/io/
    DataPool.h:35-70, FastxStream.h:292-364), so input IO overlaps
    phase A on multicore hosts; chunk contents and order are identical
    to the synchronous path (same parser). ``producer=False`` keeps
    parsing on the calling thread."""

    def __init__(self, path1: str, path2: str = "", interleaved: bool = False,
                 chunk_size: int = 10000, producer: bool = True,
                 depth: int = 8):
        lib = _lib()
        self.lib = lib
        self.use_producer = bool(producer)
        if self.use_producer:
            self.handle = lib.fastx_open_async(
                path1.encode(), (path2 or "").encode(), int(interleaved),
                chunk_size, depth,
            )
        else:
            self.handle = lib.fastx_open(
                path1.encode(), (path2 or "").encode(), int(interleaved),
                chunk_size,
            )
        if not self.handle:
            raise OSError(f"cannot open {path1!r}" + (f" / {path2!r}" if path2 else ""))

    def __iter__(self):
        idx = 0
        nx = (self.lib.fastx_next_async if self.use_producer
              else self.lib.fastx_next)
        er = (self.lib.fastx_error_async if self.use_producer
              else self.lib.fastx_error)
        while True:
            ch = nx(self.handle)
            # error contract (both modes): COMPLETE chunks parsed before
            # the error point are yielded, the partial chunk from the
            # failing parse is never surfaced (the producer thread frees
            # it; the sync path frees it here), then the raise
            err = er(self.handle)
            if err and not self.use_producer and ch:
                self.lib.fastx_chunk_free(ch)
                ch = None
            if not ch:
                if err:
                    raise ValueError(
                        {1: "malformed FASTQ record header",
                         2: "not a FASTA or FASTQ file",
                         3: "paired input files have different lengths"}.get(
                            err, f"input error {err}")
                    )
                return
            import ctypes as c

            n_pairs = c.c_int64()
            n_singles = c.c_int64()
            self.lib.fastx_counts(ch, c.byref(n_pairs), c.byref(n_singles))
            yield idx, ch, int(n_pairs.value), int(n_singles.value)
            idx += 1

    def free_chunk(self, ch) -> None:
        if self.use_producer:
            self.lib.fastx_release_async(self.handle, ch)
        else:
            self.lib.fastx_chunk_free(ch)

    def close(self) -> None:
        if self.handle:
            if self.use_producer:
                self.lib.fastx_close_async(self.handle)
            else:
                self.lib.fastx_close(self.handle)
            self.handle = None

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass
