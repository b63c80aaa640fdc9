"""Chunk-level NAM finding in the native engine.

`find_nams_chunk` runs seeding, index lookup and NAM chaining (and the
rescue) for a list of reads in one C++ call (the engine's
`seednam_chunk`) and returns per-read NAM lists equal to the Python path
(seed/randstrobes.py + chain/nams.py). It is the fast host reference the
device NAM front end is held against at a chunk's size. A copy of
rabbitsalign_tpu/chain/native_nams.py over the port's engine.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..index.params import IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..native import load_engine, native_disabled
from .nams import Nam


def native_available() -> bool:
    """Whether NAMs can be found in the engine: false only under
    RABBITSALIGN_TPU_NO_NATIVE, where the Python find_nams takes over.
    Otherwise the engine is loaded (built if need be), and a build that
    fails raises; there is no silent fallback."""
    if native_disabled():
        return False
    load_engine()
    return True


def _seednam_lib() -> ctypes.CDLL:
    lib = load_engine()
    if not getattr(lib, "_seednam_configured", False):
        p, i, u32, u64, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64,
                               ctypes.c_int64)
        lib.seednam_chunk.restype = p
        # hashes, positions, packed, buckets, n_index, bits, filter_cutoff,
        # seqs, offsets, n_reads, k s t, w_min w_max, qmask max_dist,
        # rescue_cutoff rescue_level
        lib.seednam_chunk.argtypes = [p, p, p, p, u64, i, u32, p, p, i64, i, i, i, i, i, u64, i,
                                      u32, i]
        lib.seednam_total_nams.restype = i64
        lib.seednam_total_nams.argtypes = [p]
        lib.seednam_copy.restype = None
        lib.seednam_copy.argtypes = [p] * 6
        lib.seednam_free.restype = None
        lib.seednam_free.argtypes = [p]
        lib._seednam_configured = True
    return lib


def find_nams_chunk(
    seqs: List[bytes],
    index: StrobemerIndex,
    params: IndexParameters,
    rescue_cutoff: int,
    rescue_level: int,
) -> Tuple[List[List[Nam]], np.ndarray, np.ndarray]:
    """Returns (nams per read, nonrepetitive_fraction (n,) float32,
    used_rescue (n,)). With rescue_level <= 1 no rescue is attempted
    (reference src/aln.cpp:2337-2344)."""
    lib = _seednam_lib()
    n = len(seqs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    blob = b"".join(seqs)
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    hashes, positions, packed, buckets = (
        np.ascontiguousarray(a) for a in (index.hashes, index.positions, index.packed,
                                          index.randstrobe_start_indices))
    sp = params.syncmer
    rp = params.randstrobe
    handle = lib.seednam_chunk(
        hashes.ctypes.data, positions.ctypes.data, packed.ctypes.data, buckets.ctypes.data,
        hashes.shape[0], index.bits, index.filter_cutoff,
        blob_arr.ctypes.data, offsets.ctypes.data, n,
        sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q & ((1 << 64) - 1), rp.max_dist,
        rescue_cutoff, rescue_level,
    )
    try:
        total = lib.seednam_total_nams(handle)
        nam_offsets = np.zeros(n + 1, dtype=np.int64)
        flat_int = np.zeros((max(total, 1), 10), dtype=np.int32)
        flat_score = np.zeros(max(total, 1), dtype=np.float32)
        nonrep = np.zeros(n, dtype=np.float32)
        used_rescue = np.zeros(n, dtype=np.int32)
        lib.seednam_copy(handle, nam_offsets.ctypes.data, flat_int.ctypes.data,
                         flat_score.ctypes.data, nonrep.ctypes.data, used_rescue.ctypes.data)
    finally:
        lib.seednam_free(handle)

    rows = flat_int[:total].tolist()
    scores = flat_score[:total].tolist()
    out: List[List[Nam]] = []
    for r in range(n):
        lo, hi = int(nam_offsets[r]), int(nam_offsets[r + 1])
        # row: nam_id, query start/end/prev, ref start/end/prev, n_hits,
        # ref_id, is_rc
        out.append([Nam(*rows[j][:9], scores[j], bool(rows[j][9])) for j in range(lo, hi)])
    return out, nonrep, used_rescue
