"""The port's strobemer index against the JAX package's: the native
build, `.sti` files written by either package read back identically by
the other, and `from_jax_arrays`."""

import numpy as np
import pytest

from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxStrobemerIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import InvalidIndexFile, StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References

_ARRAYS = ("hashes", "positions", "packed", "randstrobe_start_indices")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.RandomState(11)
    path = tmp_path_factory.mktemp("torch_index") / "ref.fa"
    with open(path, "wb") as f:
        for name, n in (("chrA", 40_000), ("chrB", 7_000), ("chrC", 300)):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
            f.write(b">" + name.encode() + b" description\n")
            for i in range(0, n, 70):
                f.write(seq[i:i + 70] + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def indexes(fasta):
    jax_index = JaxStrobemerIndex(JaxReferences.from_fasta(fasta),
                                  JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    port_index = StrobemerIndex(References.from_fasta(fasta),
                                IndexParameters.from_read_length(150))
    port_index.populate(0.0002)
    return jax_index, port_index


def _assert_same(port_index, jax_index):
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(port_index, name), getattr(jax_index, name))
    assert port_index.filter_cutoff == jax_index.filter_cutoff
    assert port_index.bits == jax_index.bits


def test_references_match_jax(fasta):
    port, jax_refs = References.from_fasta(fasta), JaxReferences.from_fasta(fasta)
    assert (port.names, port.sequences, port.lengths) == (
        jax_refs.names, jax_refs.sequences, jax_refs.lengths)


def test_native_build_matches_jax(indexes):
    jax_index, port_index = indexes
    assert len(port_index) > 1000
    _assert_same(port_index, jax_index)


def test_sti_interop_both_ways(indexes, fasta, tmp_path):
    jax_index, port_index = indexes
    jax_sti, port_sti = tmp_path / "jax.sti", tmp_path / "port.sti"
    jax_index.write(str(jax_sti))
    port_index.write(str(port_sti))
    assert jax_sti.read_bytes() == port_sti.read_bytes()

    port_read = StrobemerIndex(References.from_fasta(fasta), IndexParameters.from_read_length(150))
    port_read.read(str(jax_sti))
    _assert_same(port_read, jax_index)
    jax_read = JaxStrobemerIndex(JaxReferences.from_fasta(fasta),
                                 JaxIndexParameters.from_read_length(150))
    jax_read.read(str(port_sti))
    _assert_same(port_index, jax_read)


def test_sti_read_rejects_other_parameters(indexes, fasta, tmp_path):
    sti = tmp_path / "r150.sti"
    indexes[1].write(str(sti))
    other = StrobemerIndex(References.from_fasta(fasta), IndexParameters.from_read_length(250))
    with pytest.raises(InvalidIndexFile):
        other.read(str(sti))


def test_from_jax_arrays(indexes, fasta, tmp_path):
    jax_index, _ = indexes
    port = StrobemerIndex.from_jax_arrays(
        References.from_fasta(fasta), IndexParameters.from_read_length(150),
        *(np.asarray(getattr(jax_index, name)) for name in _ARRAYS),
        filter_cutoff=jax_index.filter_cutoff, bits=jax_index.bits)
    _assert_same(port, jax_index)
    port.write(str(tmp_path / "a.sti"))
    jax_index.write(str(tmp_path / "b.sti"))
    assert (tmp_path / "a.sti").read_bytes() == (tmp_path / "b.sti").read_bytes()


def test_index_statistics_match_jax(indexes, tmp_path):
    """--index-statistics writes the same CSV from either package."""
    from rabbitsalign_tpu.index.diagnostics import print_diagnostics as jax_print_diagnostics
    from rabbitsalign_tpu_torch.index.diagnostics import print_diagnostics

    jax_index, port_index = indexes
    jax_print_diagnostics(jax_index, str(tmp_path / "jax.csv"), 20)
    print_diagnostics(port_index, str(tmp_path / "port.csv"), 20)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
