"""The native (C++) mapping engine, built from this package's own sources
and loaded via ctypes.

`engine.cpp` (which #includes `seednam.cpp` beside it) lives in this
directory, a copy of the JAX package's engine with the same code (only
its comments' paths to the reference source are shortened; the parity
tests hold the two libraries against each other). It is compiled
with g++ into a cache of this package's own
(``$RABBITSALIGN_TPU_TORCH_CACHE``, default
``~/.cache/rabbitsalign_tpu_torch``), and rebuilt unless the stamp beside
the library holds the sha256 of both sources and the compiler flags
(mtimes cannot be trusted: an unpacked archive carries its commit's
times). A failed build raises, and its message names
RABBITSALIGN_TPU_NO_NATIVE: only that variable, set by the caller, turns
the engine off. Under it `load_engine` raises, `sort_perm`,
`robinhood_order` and `hamming_try` return None, and their callers take
the JAX package's Python paths (a stable sort, insertion order, the
Python Hamming), as that package does without its library; the runner
then maps with the Python mapper (pipeline/batched.py).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

ENGINE_SRC_DIR = Path(__file__).resolve().parent
ENGINE_SOURCES = ("engine.cpp", "seednam.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

NO_NATIVE_ENV = "RABBITSALIGN_TPU_NO_NATIVE"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def native_disabled() -> bool:
    """True while RABBITSALIGN_TPU_NO_NATIVE is set to a non-empty value
    (read at every call, so a test may set and clear it)."""
    return bool(os.environ.get(NO_NATIVE_ENV))


def cache_dir() -> Path:
    return Path(os.environ.get(
        "RABBITSALIGN_TPU_TORCH_CACHE",
        os.path.expanduser("~/.cache/rabbitsalign_tpu_torch")))


def sources_digest() -> str:
    """sha256 over the names and contents of ENGINE_SOURCES and GXX_FLAGS."""
    h = hashlib.sha256(repr(GXX_FLAGS).encode())
    for name in ENGINE_SOURCES:
        h.update(name.encode() + b"\0" + (ENGINE_SRC_DIR / name).read_bytes() + b"\0")
    return h.hexdigest()


_NO_NATIVE_HINT = (f"set {NO_NATIVE_ENV}=1 to map with the Python mapper instead "
                   f"(about 100x slower)")


def build_engine() -> Path:
    """Compile engine.cpp into the cache unless the library's stamp holds
    `sources_digest()`, and return the library's path. Concurrent builds
    (test workers) take turns on a lock file, and the build writes a
    private temporary file that is renamed into place, so a reader never
    sees a partial library."""
    missing = [s for s in ENGINE_SOURCES if not (ENGINE_SRC_DIR / s).is_file()]
    if missing:
        raise RuntimeError(f"engine sources not found in {ENGINE_SRC_DIR}: {missing}")
    out = cache_dir() / "engine.so"
    stamp = out.with_name("engine.so.sha256")
    digest = sources_digest()

    def fresh() -> bool:
        return out.exists() and stamp.exists() and stamp.read_text() == digest

    if fresh():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # one build at a time; the others wait and then find it fresh
    with open(out.with_name("engine.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return out
        _compile(ENGINE_SRC_DIR / ENGINE_SOURCES[0], out)
        tmp = stamp.with_name(f"engine.so.{os.getpid()}.{threading.get_ident()}.sha256")
        tmp.write_text(digest)
        os.replace(tmp, stamp)
        return out


def _compile(src: Path, out: Path) -> Path:
    tmp = out.with_name(f"engine.{os.getpid()}.{threading.get_ident()}.so")
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), "-lz"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native engine build failed: {e}; {_NO_NATIVE_HINT}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native engine build failed ({' '.join(cmd)}); {_NO_NATIVE_HINT}:\n"
            f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_engine() -> ctypes.CDLL:
    """Load (building if needed) the native engine library. Raises under
    RABBITSALIGN_TPU_NO_NATIVE."""
    global _lib
    if native_disabled():
        raise RuntimeError(f"the engine is turned off by {NO_NATIVE_ENV}")
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_engine()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for name, args in (("sort_perm_u64_asc", [p, i64, p]),
                               ("sort_perm_f64_desc", [p, i64, p]),
                               ("robinhood_iteration_order", [p, i64, i64, p])):
                getattr(lib, name).restype = None
                getattr(lib, name).argtypes = args
            # query, ref, n, match, mismatch, end_bonus, vals, cigar, cap, n_cigar
            lib.hamming_try.restype = ctypes.c_int
            lib.hamming_try.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, p, p, i64, p]
            _lib = lib
        return _lib


def sort_perm(keys, descending: bool):
    """The permutation (int32) in which the reference's std::sort orders
    `keys`: uint64 ascending, or float64 descending (libstdc++'s introsort
    is unstable, and its order of equal keys is observable output).
    None under RABBITSALIGN_TPU_NO_NATIVE: the caller then sorts stably,
    which differs only in the order of equal keys."""
    import numpy as np

    if native_disabled():
        return None
    lib = load_engine()
    n = keys.shape[0]
    perm = np.empty(n, dtype=np.int32)
    if descending:
        keys = np.ascontiguousarray(keys, dtype=np.float64)
        lib.sort_perm_f64_desc(keys.ctypes.data, n, perm.ctypes.data)
    else:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        lib.sort_perm_u64_asc(keys.ctypes.data, n, perm.ctypes.data)
    return perm


def robinhood_order(keys):
    """Iteration order of the reference's robin_hood::unordered_map after
    inserting `keys` (unique u32 ref_ids) in first-touch order, as an
    int32 permutation: the order of NAMs on different contigs, which
    equal-score tie-breaks observe (reference ext/robin_hood.h, simulated
    by the engine). None under RABBITSALIGN_TPU_NO_NATIVE, where the
    caller keeps insertion order; without the variable an engine that
    does not load raises."""
    import numpy as np

    if native_disabled():
        return None
    lib = load_engine()
    arr = np.ascontiguousarray(keys, dtype=np.uint32)
    perm = np.empty(arr.shape[0], dtype=np.int32)
    # every reference construction site reserves 100 (src/nam.cpp:589 etc.)
    lib.robinhood_iteration_order(arr.ctypes.data, arr.shape[0], 100, perm.ctypes.data)
    return perm


_HAM_CIGAR_CAP = 4096
_ham_local = threading.local()


def hamming_try(query: bytes, ref: bytes, match: int, mismatch: int, end_bonus: int):
    """The engine's Hamming fast path (seednam.cpp hamming_try): (score,
    seg_start, seg_end, edits, packed cigar ops) when the gate of under
    5% mismatches passes, False when it fails (a gapped alignment is
    needed), and None under RABBITSALIGN_TPU_NO_NATIVE (the caller runs
    the Python Hamming)."""
    import numpy as np

    if native_disabled():
        return None
    lib = load_engine()
    if len(query) != len(ref) or len(query) == 0:
        return False  # the gate cannot pass
    bufs = getattr(_ham_local, "bufs", None)
    if bufs is None:  # per thread: mapping workers call this concurrently
        bufs = _ham_local.bufs = (np.zeros(4, np.int32), np.zeros(_HAM_CIGAR_CAP, np.uint32),
                                  np.zeros(1, np.int64))
    vals, cigar, n_cigar = bufs
    if not lib.hamming_try(query, ref, len(query), match, mismatch, end_bonus, vals.ctypes.data,
                           cigar.ctypes.data, _HAM_CIGAR_CAP, n_cigar.ctypes.data):
        return False
    return (int(vals[0]), int(vals[1]), int(vals[2]), int(vals[3]),
            cigar[: int(n_cigar[0])].tolist())
