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
Construction runs in the native engine (native/__init__.py). The columnar
sidecar of ``--mmap-index`` (`write_columns` / `read_mmap`) is
rabbitsalign_tpu's, file for file.
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
    END = np.uint64(0xFFFFFFFFFFFFFFFF)  # "not found" sentinel

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

    # --- accessors and lookup (reference src/index.hpp:57-147) ----------

    def k(self) -> int:
        return self.parameters.syncmer.k

    def size(self) -> int:
        return len(self)

    def get_hash(self, position):
        """Hash at position; out of range gives the END sentinel."""
        position = np.asarray(position)
        in_range = position < self.hashes.shape[0]
        safe = np.where(in_range, position, 0)
        return np.where(in_range, self.hashes[safe], self.END)

    def reference_index(self, position):
        return self.packed[position] >> 8

    def strobe2_offset(self, position):
        return self.packed[position] & 0xFF

    def get_strobe1_position(self, position):
        return self.positions[position]

    def find(self, keys) -> np.ndarray:
        """First index of each key hash, or -1 (vectorized): the
        bucket-bounded search of StrobemerIndex::find (reference
        src/index.hpp:57-81). The bucket table does not cover the run of
        the globally smallest hash (`_build_buckets`), so that run and
        keys in an empty bucket are missing."""
        keys = np.asarray(keys, dtype=np.uint64)
        scalar = keys.ndim == 0
        keys = np.atleast_1d(keys)
        pos = np.searchsorted(self.hashes, keys, side="left")
        tops = (keys >> np.uint64(64 - self.bits)).astype(np.int64)
        lo = self.randstrobe_start_indices[tops].astype(np.int64)
        hi = self.randstrobe_start_indices[tops + 1].astype(np.int64)
        in_range = (pos >= lo) & (pos < hi) & (pos < self.hashes.shape[0])
        safe = np.where(pos < self.hashes.shape[0], pos, 0)
        found = in_range & (self.hashes[safe] == keys)
        out = np.where(found, pos, -1).astype(np.int64)
        return out[0] if scalar else out

    def get_count(self, position) -> np.ndarray:
        """Number of entries sharing the hash at `position`, counted from
        `position` onward (reference src/index.hpp:115-147)."""
        position = np.atleast_1d(np.asarray(position, dtype=np.int64))
        key = self.hashes[position]
        end = np.searchsorted(self.hashes, key, side="right")
        out = (end - position).astype(np.int64)
        return out if out.shape[0] > 1 else out[0]

    def is_filtered(self, position) -> np.ndarray:
        """Repetitive-seed filter: true when the hash still appears
        `filter_cutoff` entries later (reference src/index.hpp:91-93)."""
        position = np.asarray(position, dtype=np.int64)
        return self.get_hash(position) == self.get_hash(position + self.filter_cutoff)

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
        contig like the reference's count/assign workers; under
        RABBITSALIGN_TPU_NO_NATIVE they run in numpy (`_populate_numpy`)."""
        import time

        from ..native import native_disabled

        t0 = time.perf_counter()
        if native_disabled():
            self._populate_numpy()
        else:
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

    def _populate_numpy(self) -> None:
        """The same arrays from the numpy seeding of seed/randstrobes.py,
        sorted by (hash, position) — RefRandstrobe::operator<."""
        import time

        from ..seed.randstrobes import randstrobes_reference

        all_hashes = []
        all_positions = []
        all_packed = []
        for ref_index, seq in enumerate(self.references.sequences):
            h, p1, p2 = randstrobes_reference(seq, self.parameters)
            all_hashes.append(h)
            all_positions.append(p1.astype(np.uint32))
            all_packed.append(
                ((np.uint32(ref_index) << np.uint32(8)) + (p2 - p1).astype(np.uint32)).astype(
                    np.uint32
                )
            )
        hashes = np.concatenate(all_hashes) if all_hashes else np.zeros(0, dtype=np.uint64)
        positions = (
            np.concatenate(all_positions) if all_positions else np.zeros(0, dtype=np.uint32)
        )
        packed = np.concatenate(all_packed) if all_packed else np.zeros(0, dtype=np.uint32)

        t1 = time.perf_counter()
        order = np.lexsort((positions, hashes))
        self.hashes = hashes[order]
        self.positions = positions[order]
        self.packed = packed[order]
        self.stats.elapsed_sorting_seeds = time.perf_counter() - t1

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

    # --- columnar mmap sidecar (--mmap-index) --------------------------
    #
    # The .sti interleaves 16-byte records, so loading it means a full
    # sequential read + de-interleave: a 12 GB GRCh38-class index costs
    # minutes of startup on a ~140 MB/s cloud disk (the reference's
    # fread load, src/index.cpp:91-132, pays the same). The sidecar
    # stores each column CONTIGUOUSLY so the index can be np.memmap'd:
    # open is O(1), pages fault in on demand, and a background warmer
    # thread streams the files through the page cache at sequential
    # disk speed so mapping overlaps IO instead of stalling behind it.
    # The engine's zero-copy pointers work on memmap'd columns
    # unchanged. The .sti stays the byte-interchange format; the
    # sidecar is a pure cache, keyed on the .sti's (size, mtime). Its
    # files are byte-identical to rabbitsalign_tpu's, so either package
    # opens the sidecar the other wrote.

    COLS_VERSION = 1

    def _cols_dir(self, filename: str) -> str:
        return filename + ".cols"

    @staticmethod
    def _sti_fingerprint(filename: str, probes: int = 3) -> str:
        """Cheap content fingerprint of the .sti: size + sha1 over
        `probes` uniformly-spread 64 KiB windows (k=3 = head, middle,
        tail — byte-compatible with the original 3-probe layout).
        Size+mtime alone misses a cp -p'd stale .sti (same size,
        preserved mtime, different bytes); hashing all 12 GB would cost
        the sidecar's whole point. Validation uses the dense k=64
        variant when the .sti's mtime changed since the sidecar was
        built (a same-size in-place rewrite is exactly when sampling
        sparsely is risky)."""
        import hashlib
        import os

        h = hashlib.sha1()
        size = os.path.getsize(filename)
        h.update(str(size).encode())
        span = max(0, size - 65536)
        offs = sorted({max(0, span * i // max(1, probes - 1))
                       for i in range(probes)})
        with open(filename, "rb") as f:
            for off in offs:
                f.seek(off)
                h.update(f.read(65536))
        return h.hexdigest()

    def write_columns(self, filename: str) -> None:
        """Write the columnar sidecar next to `filename` (the .sti)."""
        import json
        import os

        d = self._cols_dir(filename)
        # per-process tmp name: every pod host (and a concurrent bench /
        # CLI run) may build the sidecar for the same .sti at once; a
        # shared ".tmp" would be renamed away under a slower writer
        tmp = f"{d}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for name, arr in (("hashes", self.hashes),
                          ("positions", self.positions),
                          ("packed", self.packed),
                          ("buckets", self.randstrobe_start_indices)):
            with open(os.path.join(tmp, name + ".bin"), "wb") as f:
                f.write(memoryview(np.ascontiguousarray(arr)))
        st = os.stat(filename)
        hdr = {
            "version": self.COLS_VERSION,
            "n": int(self.hashes.shape[0]),
            "bits": int(self.bits),
            "filter_cutoff": int(self.filter_cutoff),
            "sti_size": st.st_size,
            "sti_mtime_ns": st.st_mtime_ns,
            "sti_sha": self._sti_fingerprint(filename),
            # dense variant, checked instead of sti_sha whenever the
            # .sti's mtime no longer matches (see read_mmap)
            "sti_sha64": self._sti_fingerprint(filename, probes=64),
        }
        with open(os.path.join(tmp, "header.json"), "w") as f:
            json.dump(hdr, f)
        import shutil

        if os.path.isdir(d):
            # two processes rebuilding the same stale sidecar can both
            # enter the rmtree; the loser must not crash mid-walk
            shutil.rmtree(d, ignore_errors=True)
        try:
            os.replace(tmp, d)
        except OSError:
            # another process published between the rmtree and the
            # rename (os.replace onto a non-empty dir raises); their
            # sidecar is equivalent — drop ours
            shutil.rmtree(tmp, ignore_errors=True)

    def read_mmap(self, filename: str, warm: bool = True) -> bool:
        """Open `filename`'s columnar sidecar as read-only memmaps.

        Returns False (caller falls back to `read`) when the sidecar is
        missing or stale. On success the header fields are set, the
        column arrays are memmaps, and (with `warm`) a daemon thread
        streams the files sequentially through the page cache so random
        faults during mapping hit already-resident pages."""
        import json
        import os

        d = self._cols_dir(filename)
        try:
            with open(os.path.join(d, "header.json")) as f:
                hdr = json.load(f)
            st = os.stat(filename)
            if (hdr.get("version") != self.COLS_VERSION
                    or hdr.get("sti_size") != st.st_size):
                return False
            if "sti_sha" in hdr:
                # content fingerprint: catches a same-size .sti swap even
                # when mtime was preserved (cp -p). When the mtime STILL
                # matches the manifest, the sparse 3-probe check
                # suffices; an mtime change means the .sti was rewritten
                # in place — exactly when sparse sampling could miss a
                # same-size content change — so use the dense 64-probe
                # fingerprint then (4 MB of reads, still O(1) vs 12 GB)
                if (hdr.get("sti_mtime_ns") == st.st_mtime_ns
                        or "sti_sha64" not in hdr):
                    if hdr["sti_sha"] != self._sti_fingerprint(filename):
                        return False
                elif hdr["sti_sha64"] != self._sti_fingerprint(filename,
                                                               probes=64):
                    return False
                else:
                    # the dense check vouches for the rewritten .sti: record
                    # its mtime, so the next open takes the sparse check
                    self._record_sti_mtime(d, hdr, st.st_mtime_ns)
            elif hdr.get("sti_mtime_ns") != st.st_mtime_ns:
                # sidecars written before the fingerprint existed
                return False
            # the parameter check read() performs must still happen:
            # parse just the .sti header (a few hundred bytes)
            with open(filename, "rb") as f:
                if f.read(4) != STI_MAGIC:
                    return False
                (version,) = struct.unpack("<I", f.read(4))
                if version != STI_FILE_FORMAT_VERSION:
                    return False
                (reserved_size,) = struct.unpack("<Q", f.read(8))
                f.seek(reserved_size, 1)
                f.seek(8, 1)  # filter_cutoff + bits (sidecar header wins)
                if IndexParameters.read(f) != self.parameters:
                    raise InvalidIndexFile(
                        "Index parameters in .sti file and those specified "
                        "on command line differ")
            n = int(hdr["n"])
            self.bits = int(hdr["bits"])
            self.filter_cutoff = int(hdr["filter_cutoff"])
            self.hashes = np.memmap(
                os.path.join(d, "hashes.bin"), dtype=np.uint64, mode="r",
                shape=(n,))
            self.positions = np.memmap(
                os.path.join(d, "positions.bin"), dtype=np.uint32, mode="r",
                shape=(n,))
            self.packed = np.memmap(
                os.path.join(d, "packed.bin"), dtype=np.uint32, mode="r",
                shape=(n,))
            self.randstrobe_start_indices = np.memmap(
                os.path.join(d, "buckets.bin"), dtype=np.uint64, mode="r",
                shape=((1 << self.bits) + 1,))
        except (OSError, ValueError, KeyError):
            return False
        for arr in (self.hashes, self.positions, self.packed,
                    self.randstrobe_start_indices):
            _madvise_willneed(arr)
        if warm:
            import threading

            files = [os.path.join(d, x + ".bin")
                     for x in ("buckets", "hashes", "positions", "packed")]
            t = threading.Thread(
                target=_warm_page_cache,
                args=(files, (self.hashes, self.positions,
                              self.randstrobe_start_indices)),
                daemon=True)
            t.start()
            # exposed so benchmarks/probes can wait for full residency
            # + the random-access warm before timing (production never
            # joins it — mapping overlaps the stream)
            self._warmer = t
        return True


    @staticmethod
    def _record_sti_mtime(d: str, hdr: dict, mtime_ns: int) -> None:
        """Rewrite the sidecar's header.json with `mtime_ns` as its
        sti_mtime_ns (a private file renamed into place). A sidecar that
        cannot be written stays as it is: the next open checks densely
        again."""
        import json
        import os
        import tempfile

        try:
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".header.")
        except OSError:
            return
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({**hdr, "sti_mtime_ns": mtime_ns}, f)
            os.replace(tmp, os.path.join(d, "header.json"))
        except OSError:
            os.unlink(tmp)


def _madvise_willneed(arr) -> None:
    """Hint the kernel to schedule readahead for a memmap'd column."""
    import ctypes
    import mmap as _mmap

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise(ctypes.c_void_p(arr.ctypes.data),
                     ctypes.c_size_t(arr.nbytes),
                     ctypes.c_int(_mmap.MADV_WILLNEED))
    except Exception:  # pragma: no cover - hint only
        pass


def _warm_page_cache(files, arrays=None) -> None:
    """Stream files sequentially through the page cache (separate fds;
    the GIL is released during readinto, so this overlaps compute on a
    single core — IO wait costs no CPU). Bucket table first: every
    lookup starts there. Once streaming completes, run the random-
    access warm pass over the index arrays (see
    warm_index_random_access) — pages are resident by then, so the
    burst targets exactly the freshly-faulted state the pass0 penalty
    attaches to."""
    import time

    from ..utils.logger import logger

    t0 = time.perf_counter()
    buf = bytearray(32 << 20)
    for path in files:
        try:
            with open(path, "rb", buffering=0) as f:
                while f.readinto(buf):
                    pass
        except OSError:  # pragma: no cover - cache warming only
            return
    logger.debug(f"index warmer: streamed in {time.perf_counter()-t0:.1f}s")
    if arrays is not None:
        t0 = time.perf_counter()
        warm_index_random_access(*arrays)
        logger.debug(
            f"index warmer: random-access warm {time.perf_counter()-t0:.1f}s")


def _warm_budget_s(default: float = 8.0) -> float:
    """RSB_INDEX_WARM_S as seconds; a value that is not a number warns
    and gives the default, so the warmer thread runs on."""
    import os

    from ..utils.logger import logger

    value = os.environ.get("RSB_INDEX_WARM_S", "")
    if not value:
        return default
    try:
        return float(value)
    except ValueError:
        logger.warning(f"RSB_INDEX_WARM_S={value!r} is not a number of seconds; "
                       f"warming for {default:g} s")
        return default


def warm_index_random_access(hashes, positions, buckets,
                             budget_s: float = None) -> None:
    """Burn off the first-pass page-mapping penalty on a freshly-loaded
    big index with a short adaptive random-access burst.

    Measured at the 3 Gbp config (tests/sanitize/pass0_probe.py and
    docs/PERF.md §4b): the first ~2 s of mapping work after the 12 GB
    index is freshly faulted runs 2-10x slow — the excess is user CPU
    in the mapping thread itself at constant frequency with zero
    guest-visible fault/THP/migration counters moving, i.e. the host
    maps freshly-allocated guest frames small and random access pays
    double page walks until the host collapses/warms them. The penalty
    burns off with random-access WORK (a sleep does not re-arm or cure
    it), so this burst absorbs it outside the mapping path: one
    controlled cold-start A/B cut the first timed pass from 6.8 s to
    1.3 s (48 k reads). Rounds self-terminate when a round stops
    getting faster (<20% improvement), so a warm index pays ~2 cheap
    rounds. RSB_INDEX_WARM_S overrides the budget; 0 disables."""
    import os
    import time

    if budget_s is None:
        budget_s = _warm_budget_s()
    n = len(hashes)
    if budget_s <= 0 or n == 0:
        return
    rng = np.random.RandomState(0xC0FFEE)
    t_end = time.perf_counter() + budget_s
    prev = None
    sink = 0
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        # realistic access mix: random hash gathers double as warm-up
        # and as searchsorted probes; positions/buckets gathers mirror
        # the NAM-building loads
        keys = hashes[rng.randint(0, n, 500_000)]
        sink += int(np.searchsorted(hashes, keys).sum())
        sink += int(positions[rng.randint(0, n, 1_000_000)].sum())
        if buckets is not None and len(buckets):
            sink += int(buckets[rng.randint(0, len(buckets),
                                            500_000)].sum())
        dt = time.perf_counter() - t0
        if prev is not None and dt > 0.8 * prev:
            break  # <20% improvement left — warm
        prev = dt
