"""The native (C++) mapping engine, built from its one source and loaded
via ctypes.

The engine is not copied into this package: `engine.cpp` (which
#includes `seednam.cpp`) is compiled by file path from the
`rabbitsalign_tpu/native/` directory of the same checkout, with the same
g++ flags as that package, into a cache of this package's own
(``$RABBITSALIGN_TPU_TORCH_CACHE``, default
``~/.cache/rabbitsalign_tpu_torch``). It is rebuilt when either source
is newer than the library. A failed build raises: there is no Python
host path behind it.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

ENGINE_SRC_DIR = Path(__file__).resolve().parents[2] / "rabbitsalign_tpu" / "native"
ENGINE_SOURCES = ("engine.cpp", "seednam.cpp")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def cache_dir() -> Path:
    return Path(os.environ.get(
        "RABBITSALIGN_TPU_TORCH_CACHE",
        os.path.expanduser("~/.cache/rabbitsalign_tpu_torch")))


def build_engine() -> Path:
    """Compile engine.cpp into the cache (if stale) and return the path.
    Concurrent builds (test workers) take turns on a lock file, and the
    build writes a private temporary file that is renamed into place, so
    a reader never sees a partial library."""
    src = ENGINE_SRC_DIR / ENGINE_SOURCES[0]
    missing = [s for s in ENGINE_SOURCES if not (ENGINE_SRC_DIR / s).is_file()]
    if missing:
        raise RuntimeError(f"engine sources not found in {ENGINE_SRC_DIR}: {missing}")
    out = cache_dir() / "engine.so"
    newest = max((ENGINE_SRC_DIR / s).stat().st_mtime for s in ENGINE_SOURCES)
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # one build at a time; the others wait and then find it fresh
    with open(out.with_name("engine.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= newest:
            return out
        return _compile(src, out)


def _compile(src: Path, out: Path) -> Path:
    tmp = out.with_name(f"engine.{os.getpid()}.{threading.get_ident()}.so")
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", str(src), "-o", str(tmp), "-lz",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native engine build failed: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native engine build failed ({' '.join(cmd)}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_engine() -> ctypes.CDLL:
    """Load (building if needed) the native engine library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_engine()))
        return _lib
