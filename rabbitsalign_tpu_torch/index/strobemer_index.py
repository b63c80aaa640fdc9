"""Strobemer index: flat hash-sorted randstrobe arrays + bucket table.

Data layout matches the reference StrobemerIndex
(reference src/index.hpp:161-183): a vector of RefRandstrobe
{hash u64, position u32, packed u32 = ref_index<<8 | strobe2_offset}
sorted by (hash, position), plus `randstrobe_start_indices` where entry x
is the index of the first randstrobe whose top `bits` hash bits are >= x
(with a guard entry at the end). The native engine reads these arrays
in place (zero-copy pointers).

Binary `.sti` v2 file interop: write()/read() are byte-compatible with
the reference (src/index.cpp:73-132), so indexes are
interchangeable with RabbitSAlign/strobealign and with rabbitsalign_tpu.
Construction runs in the native engine (native/__init__.py).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from ..io.fasta import References
from .params import BadParameter, IndexParameters

STI_MAGIC = b"STI\x01"
STI_FILE_FORMAT_VERSION = 2


class InvalidIndexFile(RuntimeError):
    pass


@dataclass
class IndexCreationStatistics:
    """Mirrors reference IndexCreationStatistics (src/index.hpp:22-35)."""

    tot_strobemer_count: int = 0
    tot_occur_once: int = 0
    tot_high_ab: int = 0
    tot_mid_ab: int = 0
    index_cutoff: int = 0
    filter_cutoff: int = 0
    distinct_strobemers: int = 0
    elapsed_hash_index: float = 0.0
    elapsed_generating_seeds: float = 0.0
    elapsed_counting_hashes: float = 0.0
    elapsed_sorting_seeds: float = 0.0


def pick_bits(total_ref_len: int, params: IndexParameters) -> int:
    """reference src/index.cpp:135-139"""
    estimated = total_ref_len // (params.syncmer.k - params.syncmer.s + 1)
    if estimated <= 0:
        return 8
    return int(np.clip(int(math.log2(estimated)) - 1, 8, 31))


class StrobemerIndex:
    def __init__(self, references: References, parameters: IndexParameters, bits: int = -1):
        self.references = references
        self.parameters = parameters
        self.bits = pick_bits(references.total_length(), parameters) if bits == -1 else bits
        if self.bits < 8 or self.bits > 31:
            raise BadParameter("Bits must be between 8 and 31")
        self.filter_cutoff = 0
        self.stats = IndexCreationStatistics()
        # struct-of-arrays RefRandstrobe storage
        self.hashes = np.zeros(0, dtype=np.uint64)
        self.positions = np.zeros(0, dtype=np.uint32)
        self.packed = np.zeros(0, dtype=np.uint32)
        self.randstrobe_start_indices = np.zeros(0, dtype=np.uint64)

    def __len__(self) -> int:
        return int(self.hashes.shape[0])

    # --- construction ---------------------------------------------------

    @classmethod
    def from_jax_arrays(cls, references: References, parameters: IndexParameters,
                        hashes, positions, packed, randstrobe_start_indices,
                        filter_cutoff: int, bits: int) -> "StrobemerIndex":
        """An index over the same state as a rabbitsalign_tpu
        StrobemerIndex, from its arrays as numpy (the ``.hashes``,
        ``.positions``, ``.packed``, ``.randstrobe_start_indices``,
        ``.filter_cutoff`` and ``.bits`` of that object), so both engines
        map against identical index state."""
        index = cls(references, parameters, int(bits))
        index.hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
        index.positions = np.ascontiguousarray(positions, dtype=np.uint32)
        index.packed = np.ascontiguousarray(packed, dtype=np.uint32)
        index.randstrobe_start_indices = np.ascontiguousarray(
            randstrobe_start_indices, dtype=np.uint64)
        index.filter_cutoff = int(filter_cutoff)
        index.stats.tot_strobemer_count = int(index.hashes.shape[0])
        return index

    def populate(self, f: float, n_threads: int = 1) -> None:
        """Build the index (reference src/index.cpp:141-242): seeding and
        the (hash, position) sort run in the native engine, threaded per
        contig like the reference's count/assign workers."""
        import time

        t0 = time.perf_counter()
        self._populate_native(n_threads)
        self.stats.tot_strobemer_count = int(self.hashes.shape[0])
        self.stats.elapsed_generating_seeds = time.perf_counter() - t0

        t2 = time.perf_counter()
        self._build_buckets()
        self._compute_filter_cutoff(f)
        self.stats.elapsed_hash_index = time.perf_counter() - t2

    def _populate_native(self, n_threads: int) -> None:
        import ctypes

        from ..native import load_engine

        lib = load_engine()
        if not getattr(lib, "_index_build_configured", False):
            lib.index_build.restype = ctypes.c_void_p
            lib.index_build.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.index_build_count.restype = ctypes.c_int64
            lib.index_build_count.argtypes = [ctypes.c_void_p]
            lib.index_build_copy.restype = None
            lib.index_build_copy.argtypes = [ctypes.c_void_p] * 4
            lib.index_build_free.restype = None
            lib.index_build_free.argtypes = [ctypes.c_void_p]
            lib._index_build_configured = True

        seqs = self.references.sequences
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        for i, s in enumerate(seqs):
            offsets[i + 1] = offsets[i] + len(s)
        blob = b"".join(seqs)
        arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
        sp = self.parameters.syncmer
        rp = self.parameters.randstrobe
        handle = lib.index_build(
            arr.ctypes.data, offsets.ctypes.data, len(seqs),
            sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max,
            ctypes.c_uint64(rp.q), rp.max_dist, max(1, n_threads),
        )
        n = int(lib.index_build_count(handle))
        self.hashes = np.empty(n, dtype=np.uint64)
        self.positions = np.empty(n, dtype=np.uint32)
        self.packed = np.empty(n, dtype=np.uint32)
        lib.index_build_copy(
            handle, self.hashes.ctypes.data, self.positions.ctypes.data,
            self.packed.ctypes.data,
        )
        lib.index_build_free(handle)

    def _build_buckets(self) -> None:
        """Bucket table replicating the reference loop exactly
        (src/index.cpp:181-224), including its quirk: the loop `continue`s
        while the hash equals the previous one starting from position 0, so
        bucket entries up to the *first hash change* all point at that
        change — the run of the globally smallest hash is not reachable
        through the bucket table (inherited strobealign behavior, kept for
        byte-identical .sti files)."""
        n_buckets = 1 << self.bits
        n = self.hashes.shape[0]
        if n == 0:
            self.randstrobe_start_indices = np.full(n_buckets + 1, 0, dtype=np.uint64)
            return
        change = np.flatnonzero(self.hashes[1:] != self.hashes[:-1]) + 1
        if change.shape[0] == 0:
            # all hashes equal (e.g. one randstrobe from a tiny contig):
            # the reference loop `continue`s every position, leaving all
            # buckets at the end guard — the single run is unreachable,
            # per the first-run quirk above
            self.randstrobe_start_indices = np.full(
                n_buckets + 1, n, dtype=np.uint64)
            return
        tops_at_change = (self.hashes[change] >> np.uint64(64 - self.bits)).astype(np.uint64)
        wanted = np.arange(n_buckets + 1, dtype=np.uint64)
        idx = np.searchsorted(tops_at_change, wanted, side="left")
        starts = np.where(idx < change.shape[0], change[np.minimum(idx, change.shape[0] - 1)], n)
        self.randstrobe_start_indices = starts.astype(np.uint64)

    def _compute_filter_cutoff(self, f: float) -> None:
        """reference src/index.cpp:171-242"""
        if self.hashes.shape[0] == 0:
            self.filter_cutoff = 30
            self.stats.distinct_strobemers = 0
            return
        _, counts = np.unique(self.hashes, return_counts=True)
        unique_mers = int(counts.shape[0])
        self.stats.distinct_strobemers = unique_mers
        self.stats.tot_occur_once = int(np.sum(counts == 1))
        nonunique = counts[counts > 1]
        self.stats.tot_high_ab = int(np.sum(nonunique > 100))
        self.stats.tot_mid_ab = int(nonunique.shape[0] - self.stats.tot_high_ab)
        strobemer_counts = np.sort(nonunique)[::-1]
        index_cutoff = int(np.float64(unique_mers) * np.float32(f))
        self.stats.index_cutoff = index_cutoff
        if strobemer_counts.shape[0] > 0:
            fc = int(
                strobemer_counts[index_cutoff]
                if index_cutoff < strobemer_counts.shape[0]
                else strobemer_counts[-1]
            )
            fc = max(30, fc)
            fc = min(100, fc)
            self.filter_cutoff = fc
        else:
            self.filter_cutoff = 30
        self.stats.filter_cutoff = self.filter_cutoff

    # --- .sti binary interop (reference src/index.cpp:73-132) -----------

    def write(self, filename: str) -> None:
        with open(filename, "wb") as f:
            f.write(STI_MAGIC)
            f.write(struct.pack("<I", STI_FILE_FORMAT_VERSION))
            # reserved variable-length chunk (8 zero bytes)
            reserved = b"\x00" * 8
            f.write(struct.pack("<Q", len(reserved)))
            f.write(reserved)
            f.write(struct.pack("<i", self.filter_cutoff))
            f.write(struct.pack("<i", self.bits))
            self.parameters.write(f)
            # randstrobes vector: u64 count + packed 16-byte records,
            # streamed in blocks — materializing the whole struct array
            # doubles peak memory (20 GB at GRCh38 scale) and its fresh
            # pages dominate wall time on lazily-backed VMs
            n = self.hashes.shape[0]
            f.write(struct.pack("<Q", n))
            BLK = 4 << 20  # records per block (64 MB)
            rec = np.zeros(min(n, BLK),
                           dtype=[("hash", "<u8"), ("position", "<u4"),
                                  ("packed", "<u4")])
            for a in range(0, n, BLK):
                b = min(n, a + BLK)
                blk = rec[: b - a]
                blk["hash"] = self.hashes[a:b]
                blk["position"] = self.positions[a:b]
                blk["packed"] = self.packed[a:b]
                f.write(memoryview(blk))
            # start indices vector
            f.write(struct.pack("<Q", self.randstrobe_start_indices.shape[0]))
            f.write(self.randstrobe_start_indices.astype("<u8").tobytes())

    def read(self, filename: str) -> None:
        try:
            f = open(filename, "rb")
        except OSError as e:
            raise InvalidIndexFile(f"{filename}: {e.strerror}")
        with f:
            magic = f.read(4)
            if magic != STI_MAGIC:
                raise InvalidIndexFile(
                    "Index file has incorrect format (magic number mismatch)"
                )
            (version,) = struct.unpack("<I", f.read(4))
            if version != STI_FILE_FORMAT_VERSION:
                raise InvalidIndexFile(
                    f"Can only read index file format version {STI_FILE_FORMAT_VERSION}, "
                    f"but found version {version}"
                )
            (reserved_size,) = struct.unpack("<Q", f.read(8))
            f.seek(reserved_size, 1)
            (self.filter_cutoff,) = struct.unpack("<i", f.read(4))
            (self.bits,) = struct.unpack("<i", f.read(4))
            sti_parameters = IndexParameters.read(f)
            if sti_parameters != self.parameters:
                raise InvalidIndexFile(
                    "Index parameters in .sti file and those specified on command line differ"
                )
            (n,) = struct.unpack("<Q", f.read(8))
            # validate BEFORE allocating (like the m check below): a
            # corrupted count field must not drive 16n bytes of np.empty.
            # n has no closed form, but it is bounded by what the file
            # can actually hold past this offset
            import os as _os

            remain = _os.fstat(f.fileno()).st_size - f.tell()
            if n * 16 > remain:
                raise InvalidIndexFile(
                    f"{filename}: randstrobe count {n} exceeds file size "
                    f"({remain} bytes remain)")
            # stream the record vector in blocks straight into the column
            # arrays: a whole-file read() plus per-column copies holds
            # 2x the index transiently (20 GB at GRCh38 scale).
            # readinto() a REUSED block buffer instead of f.read(): the
            # per-block bytes allocation + extra copy capped the load at
            # ~480 MB/s; readinto measures ~1.1 GB/s cold on the same
            # disk (2.4x), and the gap widens under the CPU contention
            # that made round 3's 3 Gbp cache load take 7 minutes
            self.hashes = np.empty(n, dtype=np.uint64)
            self.positions = np.empty(n, dtype=np.uint32)
            self.packed = np.empty(n, dtype=np.uint32)
            BLK = 4 << 20  # records per block (64 MB)
            rdtype = np.dtype([("hash", "<u8"), ("position", "<u4"),
                               ("packed", "<u4")])
            buf = np.empty(BLK * 16, dtype=np.uint8)
            rec = buf.view(rdtype)
            a = 0
            while a < n:
                b = min(n, a + BLK)
                got = f.readinto(memoryview(buf)[: 16 * (b - a)])
                if got != 16 * (b - a):  # killed mid-write
                    raise InvalidIndexFile(
                        f"{filename}: truncated randstrobes vector "
                        f"({16 * a + got} of {16 * n} bytes)")
                blk = rec[: b - a]
                self.hashes[a:b] = blk["hash"]
                self.positions[a:b] = blk["position"]
                self.packed[a:b] = blk["packed"]
                a = b
            (m,) = struct.unpack("<Q", f.read(8))
            # validate BEFORE allocating: a corrupted m field would
            # otherwise drive an arbitrarily large np.empty + readinto
            # before the size check fires
            if m != (1 << self.bits) + 1:
                raise InvalidIndexFile(
                    "randstrobe_start_indices vector is of the wrong size")
            # readinto the destination array directly: read()+frombuffer+
            # copy holds and touches the (up to 2 GB at bits=28) vector
            # three times
            self.randstrobe_start_indices = np.empty(m, dtype=np.uint64)
            got = f.readinto(memoryview(self.randstrobe_start_indices))
            if got != 8 * m:
                raise InvalidIndexFile(
                    f"{filename}: truncated start-index vector")
