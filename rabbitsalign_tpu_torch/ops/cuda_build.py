"""Build and load the hand-written CUDA kernels of csrc/.

The kernels have a plain C interface (one ``*_launch`` function per
kernel, returning the ``cudaGetLastError()`` after its launch) and are
compiled by ``nvcc`` for ``sm_90a`` into one shared library, loaded with
ctypes. The build runs on first use, never at import, into
``rabbitsalign_tpu_torch/build/`` (git-ignored), and is redone when a
source is newer than the library. Concurrent builds write private
temporary files and rename them into place.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
SOURCES = ("sw_forward.cu", "sw_traceback.cu")
BUILD_DIR = PKG_DIR / "build"
LIB_PATH = BUILD_DIR / "libsw_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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


def build_kernels(extra_flags=()) -> Path:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale."""
    global build_log, build_seconds
    srcs = [CSRC_DIR / s for s in SOURCES]
    newest = max(s.stat().st_mtime for s in srcs)
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest and not extra_flags:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.{threading.get_ident()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed ({' '.join(cmd)}):\n{build_log[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sw_forward_launch.restype = i
            lib.sw_forward_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                              p, p, p, p, p, p, p]
            lib.sw_traceback_launch.restype = i
            lib.sw_traceback_launch.argtypes = [p, p, p, p, i, i, i, p, p, p, p]
            _lib = lib
        return _lib
