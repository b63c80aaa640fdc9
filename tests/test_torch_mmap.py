"""The port's `--mmap-index` sidecar against the JAX package's, on the
CPU (the port's counterpart of tests/test_index.py's sidecar test): the
same files from either package, each opening the other's, the staleness
and parameter checks, and the sidecar that `-i` writes."""

import json
import os
import shutil

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxStrobemerIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index import strobemer_index as port_index_mod
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import InvalidIndexFile, StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References

_ARRAYS = ("hashes", "positions", "packed", "randstrobe_start_indices")
_FILES = ("hashes.bin", "positions.bin", "packed.bin", "buckets.bin", "header.json")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.RandomState(17)
    path = tmp_path_factory.mktemp("torch_mmap") / "ref.fa"
    with open(path, "wb") as f:
        for name, n in (("chrA", 30_000), ("chrB", 6_000)):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, n, 70):
                f.write(seq[i:i + 70] + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def built(fasta, tmp_path_factory):
    """(jax index, port index, .sti path) with the index written once."""
    jax_index = JaxStrobemerIndex(JaxReferences.from_fasta(fasta),
                                  JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    port_index = _port_index(fasta)
    port_index.populate(0.0002)
    sti = tmp_path_factory.mktemp("sti") / "x.sti"
    port_index.write(str(sti))
    return jax_index, port_index, sti


def _port_index(fasta, r=150):
    return StrobemerIndex(References.from_fasta(fasta), IndexParameters.from_read_length(r))


def _jax_index(fasta):
    return JaxStrobemerIndex(JaxReferences.from_fasta(fasta),
                             JaxIndexParameters.from_read_length(150))


def _assert_same(a, b):
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.filter_cutoff, a.bits) == (b.filter_cutoff, b.bits)


def _copy_sti(sti, tmp_path, name):
    dst = tmp_path / name
    shutil.copyfile(sti, dst)
    return str(dst)


def test_sidecar_files_match_jax(built, tmp_path):
    """Same arrays written for two copies of one .sti: every column file is
    byte-equal, and the headers differ at most in the .sti's mtime."""
    jax_index, port_index, sti = built
    jax_sti, port_sti = _copy_sti(sti, tmp_path, "jax.sti"), _copy_sti(sti, tmp_path, "port.sti")
    jax_index.write_columns(jax_sti)
    port_index.write_columns(port_sti)
    for name in _FILES:
        assert os.path.isfile(os.path.join(port_sti + ".cols", name))
    for name in _FILES[:-1]:
        with open(os.path.join(port_sti + ".cols", name), "rb") as f:
            port_bytes = f.read()
        with open(os.path.join(jax_sti + ".cols", name), "rb") as f:
            assert port_bytes == f.read()
    headers = [json.load(open(os.path.join(p + ".cols", "header.json")))
               for p in (port_sti, jax_sti)]
    for h in headers:
        h.pop("sti_mtime_ns")
    assert headers[0] == headers[1]
    assert headers[0]["version"] == port_index_mod.StrobemerIndex.COLS_VERSION


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_opens_the_others_sidecar(built, fasta, tmp_path, writer):
    jax_index, port_index, sti = built
    path = _copy_sti(sti, tmp_path, "x.sti")
    (jax_index if writer == "jax" else port_index).write_columns(path)
    reader = _port_index(fasta) if writer == "jax" else _jax_index(fasta)
    assert reader.read_mmap(path, warm=False)
    assert isinstance(reader.hashes, np.memmap)
    _assert_same(reader, port_index)


def test_stale_sidecar_is_refused(built, fasta, tmp_path):
    _, port_index, sti = built
    path = _copy_sti(sti, tmp_path, "x.sti")
    assert not _port_index(fasta).read_mmap(path, warm=False)  # no sidecar yet
    port_index.write_columns(path)
    fresh = _port_index(fasta)
    assert fresh.read_mmap(path)  # with the warmer thread
    fresh._warmer.join(timeout=60)
    _assert_same(fresh, port_index)
    # an mtime-only touch keeps it valid: the content fingerprint is the key
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    assert _port_index(fasta).read_mmap(path, warm=False)
    # a same-size, mtime-preserved content change is caught
    st = os.stat(path)
    with open(path, "r+b") as f:
        f.seek(st.st_size - 9)
        b = f.read(1)
        f.seek(st.st_size - 9)
        f.write(bytes([b[0] ^ 0xFF]))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert not _port_index(fasta).read_mmap(path, warm=False)


def test_sidecar_with_other_parameters_raises(built, fasta, tmp_path):
    _, port_index, sti = built
    path = _copy_sti(sti, tmp_path, "x.sti")
    port_index.write_columns(path)
    with pytest.raises(InvalidIndexFile):
        _port_index(fasta, r=300).read_mmap(path, warm=False)


def test_warm_index_random_access_budget(built, monkeypatch):
    _, port_index, _ = built
    arrays = (port_index.hashes, port_index.positions, port_index.randstrobe_start_indices)
    monkeypatch.setenv("RSB_INDEX_WARM_S", "0")
    port_index_mod.warm_index_random_access(*arrays)  # disabled: returns at once
    port_index_mod.warm_index_random_access(*arrays, budget_s=0.5)


def test_malformed_warm_budget_warns_and_keeps_warming(built, monkeypatch, capsys):
    """A RSB_INDEX_WARM_S that is not a number warns and gives the default
    of 8 s; the warmer thread runs to its end instead of dying on it."""
    _, port_index, _ = built
    arrays = (port_index.hashes, port_index.positions, port_index.randstrobe_start_indices)
    monkeypatch.setenv("RSB_INDEX_WARM_S", "8s")
    assert port_index_mod._warm_budget_s() == 8.0
    assert "RSB_INDEX_WARM_S='8s' is not a number" in capsys.readouterr().err
    errors = []
    monkeypatch.setattr("threading.excepthook", errors.append)
    t = __import__("threading").Thread(target=port_index_mod.warm_index_random_access, args=arrays)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and errors == []
    monkeypatch.setenv("RSB_INDEX_WARM_S", "0.25")
    assert port_index_mod._warm_budget_s() == 0.25


def test_dense_check_records_the_sti_mtime(built, fasta, tmp_path, monkeypatch):
    """After a .sti whose mtime moved passes the dense 64-probe check, the
    sidecar's header holds the new mtime: the next open takes the sparse
    3-probe check, and the JAX package still opens the sidecar."""
    _, port_index, sti = built
    path = _copy_sti(sti, tmp_path, "x.sti")
    port_index.write_columns(path)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    probes = []
    real = StrobemerIndex._sti_fingerprint
    monkeypatch.setattr(StrobemerIndex, "_sti_fingerprint", staticmethod(
        lambda filename, probes_=3, **kw: probes.append(kw.get("probes", probes_))
        or real(filename, **kw)))
    assert _port_index(fasta).read_mmap(path, warm=False)
    header = json.load(open(os.path.join(path + ".cols", "header.json")))
    assert header["sti_mtime_ns"] == os.stat(path).st_mtime_ns
    assert _port_index(fasta).read_mmap(path, warm=False)
    assert probes == [64, 3]
    assert sorted(os.listdir(path + ".cols")) == sorted(_FILES)  # no temporary file left
    monkeypatch.undo()
    jax_reader = _jax_index(fasta)
    assert jax_reader.read_mmap(path, warm=False)
    _assert_same(jax_reader, port_index)


@pytest.mark.parametrize("flags", [[], ["--no-sidecar"]], ids=["sidecar", "no-sidecar"])
def test_create_index_writes_the_sidecar(fasta, tmp_path, flags):
    ref = tmp_path / "ref.fa"
    shutil.copyfile(fasta, ref)
    assert port_main([str(ref), "-i", "-r", "150", *flags]) == 0
    sti = str(ref) + IndexParameters.from_read_length(150).filename_extension()
    assert os.path.isfile(sti)
    cols = sti + ".cols"
    assert os.path.isdir(cols) == (not flags)
    if not flags:
        # the JAX package's -i writes the same column files
        jax_ref = tmp_path / "jax" / "ref.fa"
        jax_ref.parent.mkdir()
        shutil.copyfile(fasta, jax_ref)
        assert jax_main([str(jax_ref), "-i", "-r", "150"]) == 0
        jax_cols = str(jax_ref) + JaxIndexParameters.from_read_length(150).filename_extension() \
            + ".cols"
        for name in _FILES[:-1]:
            with open(os.path.join(cols, name), "rb") as a, \
                    open(os.path.join(jax_cols, name), "rb") as b:
                assert a.read() == b.read()
