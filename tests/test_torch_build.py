"""When the kernel library is rebuilt: the build's stamp holds a digest of
the source list, the sources, the headers they include and the nvcc flags, so a library built from
another list or other contents is rebuilt whatever the files' mtimes (an
unpacked archive carries its commit's times). A stand-in nvcc records its
calls; nothing is compiled. The port's engine the same way (its own copy of
the sources, a digest stamp), and built for real from a copy of the port
alone. Also the test run's one build of the JAX package's engine
(tests/torch_engine_cache.py), with a stand-in compiler."""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from rabbitsalign_tpu_torch import native
from rabbitsalign_tpu_torch.ops import cuda_build


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "a.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('built')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "LIB_PATH", build / "libsw_kernels.so")
    monkeypatch.setattr(cuda_build, "SOURCES", ("a.cu",))
    monkeypatch.setattr(cuda_build, "HEADERS", ("a.cuh",))

    def builds():
        return sum("-shared" in line for line in log.read_text().splitlines()) \
            if log.exists() else 0

    return csrc, build, builds


def test_library_is_rebuilt_when_the_sources_change(fake_build, monkeypatch):
    csrc, build, builds = fake_build
    lib = cuda_build.build_kernels()
    assert lib == build / "libsw_kernels.so" and lib.read_text() == "built"
    assert (build / "libsw_kernels.so.sha256").read_text() == cuda_build.sources_digest()
    assert builds() == 1
    cuda_build.build_kernels()
    assert builds() == 1  # up to date: not rebuilt

    # a source added to the list, with an mtime older than the library
    old = lib.stat().st_mtime - 3600
    os.utime(csrc / "b.cu", (old, old))
    monkeypatch.setattr(cuda_build, "SOURCES", ("a.cu", "b.cu"))
    cuda_build.build_kernels()
    assert builds() == 2
    cuda_build.build_kernels()
    assert builds() == 2

    # an edited source, its mtime set back
    (csrc / "a.cu").write_text("// a.cu, edited\n")
    os.utime(csrc / "a.cu", (old, old))
    cuda_build.build_kernels()
    assert builds() == 3

    # an edited header that the sources include
    (csrc / "a.cuh").write_text("// a.cuh, edited\n")
    os.utime(csrc / "a.cuh", (old, old))
    cuda_build.build_kernels()
    assert builds() == 4

    # diagnostic flags force a build but leave the digest alone
    cuda_build.build_kernels(extra_flags=("-Xptxas", "-v"))
    assert builds() == 5
    cuda_build.build_kernels()
    assert builds() == 5
    assert sorted(p.name for p in build.iterdir()) == ["libsw_kernels.so",
                                                        "libsw_kernels.so.sha256"]


def test_engine_is_rebuilt_when_its_sources_change(monkeypatch, tmp_path):
    """The port's engine stamp: an edited source whose mtime goes back, or
    other g++ flags, rebuild the library; an unchanged tree does not."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.ENGINE_SOURCES:
        (src / name).write_text(f"// {name}\n")
    monkeypatch.setattr(native, "ENGINE_SRC_DIR", src)
    monkeypatch.setenv("RABBITSALIGN_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    calls = []

    def fake_compile(path, out):
        calls.append(path.name)
        out.write_text(f"built {len(calls)}")
        return out

    monkeypatch.setattr(native, "_compile", fake_compile)
    lib = native.build_engine()
    assert lib == tmp_path / "cache" / "engine.so" and calls == ["engine.cpp"]
    assert (tmp_path / "cache" / "engine.so.sha256").read_text() == native.sources_digest()
    native.build_engine()
    assert len(calls) == 1  # up to date: not rebuilt
    old = lib.stat().st_mtime - 3600
    for name in native.ENGINE_SOURCES:  # each source, edited with its mtime set back
        (src / name).write_text(f"// {name}, edited\n")
        os.utime(src / name, (old, old))
        native.build_engine()
        native.build_engine()
    assert len(calls) == 3
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    native.build_engine()
    assert len(calls) == 4 and lib.read_text() == "built 4"
    assert sorted(p.name for p in lib.parent.iterdir()) == ["engine.lock", "engine.so",
                                                            "engine.so.sha256"]


def test_engine_builds_from_the_port_alone(tmp_path):
    """The port's package copied alone, with nothing of the JAX package
    beside it, builds and loads its engine (g++) into a fresh cache."""
    root = Path(native.__file__).resolve().parents[1]
    shutil.copytree(root, tmp_path / "rabbitsalign_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    assert not (tmp_path / "rabbitsalign_tpu").exists()
    probe = ("import sys\n"
             "from rabbitsalign_tpu_torch import native\n"
             "lib = native.load_engine()\n"
             "assert lib.engine_chunk_a_fx_pre and lib.engine_fx_seed_only\n"
             "assert 'rabbitsalign_tpu' not in sys.modules and 'jax' not in sys.modules\n"
             "print(native.ENGINE_SRC_DIR, native.build_engine())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(tmp_path), RABBITSALIGN_TPU_TORCH_CACHE=str(tmp_path / "cache"))
    res = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == [str(tmp_path / "rabbitsalign_tpu_torch" / "native"),
                                  str(tmp_path / "cache" / "engine.so")]
    assert (tmp_path / "cache" / "engine.so.sha256").is_file()


@pytest.fixture
def jax_cache(monkeypatch, tmp_path):
    """The JAX package's engine cache moved to an empty directory, and a
    stand-in compiler that records its calls and writes through a private
    temporary file, as native._compile does."""
    import rabbitsalign_tpu.native as jax_native

    from . import torch_engine_cache

    monkeypatch.setattr(jax_native, "_CACHE", tmp_path / "cache")
    monkeypatch.delenv("RABBITSALIGN_TPU_NO_NATIVE", raising=False)
    calls = []

    def fake_compile(src, out):
        calls.append(src.name)
        time.sleep(0.2)  # long enough for the other callers to queue on the lock
        tmp = out.with_name(f"engine.{threading.get_ident()}.so")
        tmp.write_bytes(b"library")
        os.replace(tmp, out)
        return out

    return jax_native, torch_engine_cache, fake_compile, calls


def test_jax_engine_is_built_once_for_concurrent_workers(jax_cache, monkeypatch):
    """Four callers at once: one compile, and every caller returns with
    the complete library in place; the JAX package's own loader then takes
    it without compiling."""
    jax_native, cache, fake_compile, calls = jax_cache
    out = cache.jax_engine_path()
    assert out == jax_native._CACHE / "engine.so"
    results = []
    workers = [threading.Thread(target=lambda: results.append(
        (cache.prebuild_jax_engine(fake_compile), out.read_bytes()))) for _ in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert results == [(True, b"library")] * 4
    assert calls == ["engine.cpp"]

    def no_compiler(*args, **kwargs):
        raise AssertionError("the JAX package compiled the engine again")

    monkeypatch.setattr(jax_native.subprocess, "run", no_compiler)
    assert jax_native._build("engine", deps=("seednam.cpp",)) == out


def test_jax_engine_prebuild_rebuilds_stale_and_reports_failure(jax_cache, monkeypatch):
    jax_native, cache, fake_compile, calls = jax_cache
    out = cache.jax_engine_path()
    assert cache.prebuild_jax_engine(fake_compile) and calls == ["engine.cpp"]
    assert cache.prebuild_jax_engine(fake_compile) and len(calls) == 1  # fresh: kept
    os.utime(out, (0, 0))  # older than the sources
    assert cache.prebuild_jax_engine(fake_compile) and len(calls) == 2

    def failing(src, out):
        raise RuntimeError("native engine build failed")

    os.utime(out, (0, 0))
    assert cache.prebuild_jax_engine(failing) is False  # reported, not raised
    monkeypatch.setenv("RABBITSALIGN_TPU_NO_NATIVE", "1")
    assert cache.prebuild_jax_engine(fake_compile) is False and len(calls) == 2
