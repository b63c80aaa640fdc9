"""Build the JAX package's native engine once for a test run.

rabbitsalign_tpu/native/__init__.py compiles engine.so straight into its
cache path, with no lock, and three test modules (test_engine.py,
test_multihost_procs.py, test_native.py) load it while they are
collected. Under pytest-xdist every worker collects every module at
about the same time, so from a cold cache all of them compile into the
same file: the linker truncates and rewrites it in place, and a worker
that opens it meanwhile fails to load it. Its loader has already marked
itself as tried, so that worker runs without the engine for the rest of
its life: the tests it runs that need the engine fail ("native engine
unavailable") or skip.

`prebuild_jax_engine` compiles the library first from the JAX package's
own sources, with its g++ flags (the port's `native._compile`: a private
temporary file renamed into place), under a file lock. The processes that wait find a complete
library newer than its sources, which the package's loader takes as it
is. tests/test_torch_engine_cache/conftest.py calls it before any test
module is collected.
"""

import fcntl
import os
import sys
from pathlib import Path

from rabbitsalign_tpu_torch.native import ENGINE_SOURCES, _compile

JAX_ENGINE_DIR = Path(__file__).resolve().parents[1] / "rabbitsalign_tpu" / "native"


def jax_engine_path() -> Path:
    """Where rabbitsalign_tpu.native loads engine.so from."""
    from rabbitsalign_tpu.native import _CACHE

    return Path(_CACHE) / "engine.so"


def prebuild_jax_engine(compile_engine=_compile) -> bool:
    """Make jax_engine_path() a complete library newer than the engine's
    sources, compiling it at most once among the processes that call this
    at the same time. False (with a message) if the build failed, so the
    package's loader then tries on its own, as it would without this;
    also False under RABBITSALIGN_TPU_NO_NATIVE, which turns the engine
    off."""
    if os.environ.get("RABBITSALIGN_TPU_NO_NATIVE"):
        return False
    out = jax_engine_path()
    newest = max((JAX_ENGINE_DIR / s).stat().st_mtime for s in ENGINE_SOURCES)

    def fresh() -> bool:
        return out.exists() and out.stat().st_mtime >= newest

    try:
        if fresh():
            return True
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out.with_name("engine.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not fresh():
                compile_engine(JAX_ENGINE_DIR / ENGINE_SOURCES[0], out)
    except (OSError, RuntimeError) as e:  # e.g. a cache that cannot be written
        print(f"tests: building {out} failed: {e}", file=sys.stderr)
        return False
    return True
