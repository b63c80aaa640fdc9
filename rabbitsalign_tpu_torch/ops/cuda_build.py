"""Build and load the hand-written CUDA kernels of csrc/.

The kernels have a plain C interface (one ``*_launch`` function per
kernel, returning the ``cudaGetLastError()`` after its launch) and are
compiled by ``nvcc`` for ``sm_90a`` into one shared library, loaded with
ctypes: one ``nvcc -c`` per source, all started together, then one link.
The build runs on first use, never at import, into
``rabbitsalign_tpu_torch/build/`` (git-ignored), and is redone unless the
stamp beside the library holds the digest of the current source list,
their contents and the nvcc flags (mtimes cannot be trusted: an unpacked
archive carries its commit's times). Concurrent builds write private
temporary files and rename them into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
SOURCES = ("sw_forward.cu", "sw_traceback.cu", "int16_probe.cu", "seed_randstrobes.cu",
           "index_find.cu", "find_runs.cu", "launch_floor.cu", "syncmers_scan.cu",
           "merge_hits.cu", "walk_hits.cu", "extend_q2.cu")
# included by SOURCES, so in the digest too
HEADERS = ("bucket_search.cuh", "extend_layout.cuh")
BUILD_DIR = PKG_DIR / "build"
LIB_PATH = BUILD_DIR / "libsw_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# compiler output and wall time of the last build made by this process
build_log = ""
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ on first use")
    return found


def sources_digest() -> str:
    """sha256 over the names and contents of SOURCES and HEADERS, and
    NVCC_FLAGS."""
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (CSRC_DIR / name).read_bytes() + b"\0")
    return h.hexdigest()


def build_kernels(extra_flags=()) -> Path:
    """Compile csrc/*.cu into LIB_PATH unless the library's stamp matches
    `sources_digest()`: every source to an object at once, then one shared
    library. `extra_flags` (diagnostics such as ``-Xptxas -v``) force a
    build and do not enter the digest."""
    global build_log, build_seconds
    srcs = [CSRC_DIR / s for s in SOURCES]
    digest = sources_digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if (not extra_flags and LIB_PATH.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{tag}.so")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(src), "-o", str(obj)]
                             for src, obj in zip(srcs, objs))]
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in logs):
            res = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, res.stdout + res.stderr, res.returncode))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(out for _, out, _ in logs)
        for cmd, out, rc in logs:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"CUDA kernel build failed ({' '.join(cmd)}):\n{out[-4000:]}")
        os.replace(tmp, LIB_PATH)
        tmp.with_suffix(".sha256").write_text(digest)
        os.replace(tmp.with_suffix(".sha256"), stamp)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return LIB_PATH


def _signatures() -> dict:
    """The argument types of each ``*_launch`` entry (all return int)."""
    p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    fwd = [p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    fwd_q2 = [p, p, i64, i, i, i, i, i, i, i, p, p, p, p, p]
    return {
        "sw_forward_launch": fwd,
        "sw_forward_i16_launch": fwd,
        "sw_forward_split_launch": [p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p],
        "sw_forward_q2_launch": fwd_q2,
        "sw_forward_q2_i16_launch": fwd_q2,
        "extend_q2_enqueue": [p, p, i64, p, i64, i, i, i, i, i, i, i, i, i, p],
        "extend_q2_scratch_bytes": [i, i, i, p],
        "sw_traceback_launch": [p, p, p, p, i, i, i, p, p, p, p],
        "sw_traceback_packed_launch": [p, p, p, p, i, i, i, p, p],
        "int16_probe_launch": [p, p, i, i, p],
        "seed_randstrobes_launch": [p, p, i, i, i, i, i, i, i, u64, i, i, p, p, p, p, p, p, p,
                                    p],
        "index_find_launch": [p, i64, p, i, p, i64, p, p],
        "find_runs_launch": [p, i64, i64, i64, p, i64, i, i64, p, i64, p, p, p],
        "gather_runs_launch": [p, p, p, p, i64, p, i64, i64, p, p, p],
        "empty_launch": [i, i, p],
        "syncmers_scan_launch": [p, p, i, i, i, i, i, i, p, p, p, p],
        "merge_hits_launch": [p, p, p, i64, i64, i, i, p, p, p, p, p],
        "walk_hits_launch": [p, p, p, p, p, p, p, i64, p, p, p, i64, i, i, i, i, p, p, p, p, p,
                             p],
    }


def declare(lib: ctypes.CDLL, names=None) -> None:
    """Set the C signatures of `lib`'s launch entries (those in `names`,
    or all of them)."""
    for name, args in _signatures().items():
        if names is None or name in names:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            declare(lib)
            _lib = lib
        return _lib
