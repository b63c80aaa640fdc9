"""When the kernel library is rebuilt: the build's stamp holds a digest of
the source list, the sources and the nvcc flags, so a library built from
another list or other contents is rebuilt whatever the files' mtimes (an
unpacked archive carries its commit's times). A stand-in nvcc records its
calls; nothing is compiled."""

import os
import sys

import pytest

from rabbitsalign_tpu_torch.ops import cuda_build


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
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

    # diagnostic flags force a build but leave the digest alone
    cuda_build.build_kernels(extra_flags=("-Xptxas", "-v"))
    assert builds() == 4
    cuda_build.build_kernels()
    assert builds() == 4
    assert sorted(p.name for p in build.iterdir()) == ["libsw_kernels.so",
                                                        "libsw_kernels.so.sha256"]
