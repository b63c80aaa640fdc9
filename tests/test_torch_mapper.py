"""The port's Python mapper against rabbitsalign_tpu's and against the
port's own engine, exact. `phase_a_chunk` -> the BatchAligner on the CPU
(the kernels' plain versions) -> `phase_b_chunk` over
tests/test_engine.py's simulated SE and PE worlds, in every output mode,
equals the JAX package's `run_python` and the port's NativeEngine
chunk_a/chunk_b byte for byte, with the same statistics and insert-size
state. Beside it: InputBuffer against the JAX one and against
the port's native reader; MinstdRand streams; the numpy index build
against the engine's; and the NAMs from the sharded index against the
JAX package's, with their SE end-to-end SAM."""

import gzip
import random
from unittest import mock

import numpy as np
import pytest

from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
from rabbitsalign_tpu.chain import sharded_nams as jsharded
from rabbitsalign_tpu.index.params import IndexParameters as JaxParams
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io import fastq as jfastq
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.map import randomness as jrandomness
from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
from rabbitsalign_tpu.seed.randstrobes import randstrobes_query as jax_query
from rabbitsalign_tpu_torch.align.aligner import Aligner, AlignmentParameters
from rabbitsalign_tpu_torch.chain import nams
from rabbitsalign_tpu_torch.chain.sharded_nams import (find_nams_rescue_sharded,
                                                       find_nams_sharded)
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io import fastq
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.io.sam import CIGAR_OPS_EQX, CIGAR_OPS_M, Sam, SamRecord
from rabbitsalign_tpu_torch.map import randomness
from rabbitsalign_tpu_torch.map import se as se_mod
from rabbitsalign_tpu_torch.map.common import InsertSizeDistribution, MappingParameters
from rabbitsalign_tpu_torch.map.randomness import MinstdRand
from rabbitsalign_tpu_torch.map.stats import AlignmentStatistics
from rabbitsalign_tpu_torch.native.engine import NativeEngine, NativeReader
from rabbitsalign_tpu_torch.ops import batch_extend, extend_device
from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh
from rabbitsalign_tpu_torch.pipeline import batched
from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

from .test_engine import run_python, simulate_pe, simulate_se
from .test_torch_align import one_torch_thread  # noqa: F401 (autouse fixture)
from .test_sharded_index import _repetitive_world

NO_NATIVE = "RABBITSALIGN_TPU_NO_NATIVE"


@pytest.fixture(scope="module")
def world():
    """tests/test_engine.py's world in both packages: the JAX index, and
    the port's over its arrays."""
    rng = random.Random(99)
    genome = "".join(rng.choice("ACGT") for _ in range(300_000))
    jrefs, refs = JaxReferences(), References()
    for r in (jrefs, refs):
        r.add("chr1", genome[:200_000].encode())
        r.add("chr2", genome[200_000:].encode())
    jparams = JaxParams.from_read_length(150)
    jindex = JaxIndex(jrefs, jparams)
    jindex.populate(0.0002)
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex.from_jax_arrays(
        refs, params, jindex.hashes, jindex.positions, jindex.packed,
        jindex.randstrobe_start_indices, jindex.filter_cutoff, jindex.bits)
    return genome, (jrefs, jparams, jindex), (refs, params, index)


def _port_records(records):
    return [SamRecord(r.name, r.seq, r.qual) for r in records]


def _port_chunks(chunks):
    return [tuple(_port_records(part) for part in chunk) for chunk in chunks]


def run_port(port, chunks, mp, ap, batch):
    """tests/test_engine.py:run_python over the port's modules."""
    refs, params, index = port
    aligner = Aligner(ap)
    stats = AlignmentStatistics()
    isize = InsertSizeDistribution()
    cigar_ops = CIGAR_OPS_EQX if mp.cigar_eqx else CIGAR_OPS_M
    texts = []
    for ci, (r1, r2, r3) in enumerate(_port_chunks(chunks)):
        eng = MinstdRand(0)
        eng.seed(ci)
        paf = []
        sam = Sam(refs, cigar_ops, "", mp.output_unmapped, mp.details)
        work, _ = batched.phase_a_chunk(r1, r2, r3, paf, isize, aligner, batch, mp, params, refs,
                                        index, eng)
        infos = batch.flush()
        batched.phase_b_chunk(work, infos, sam, stats, isize, aligner, mp, params, refs, eng)
        texts.append(sam.take() if mp.is_sam_out else "".join(paf))
    stats.tot_aligner_calls = aligner.calls_count()
    return "".join(texts), stats, isize


def run_engine(port, chunks, mp, ap):
    refs, params, index = port
    eng = NativeEngine(index, params, refs, ap, mp, "")
    texts = [eng.chunk_b_bytes(eng.chunk_a(r1, r2, r3, ci))
             for ci, (r1, r2, r3) in enumerate(_port_chunks(chunks))]
    return b"".join(texts).decode(), eng


MAP_MODES = {
    "sam": {},
    "paf": {"is_sam_out": False},
    "eqx": {"cigar_eqx": True},
    "N2-details": {"max_secondary": 2, "details": True},
    "U": {"output_unmapped": False},
}


def _chunks(world, kind):
    genome = world[0]
    if kind == "se":
        se = simulate_se(genome, 100)
        return [(se[i:i + 50], [], []) for i in range(0, 100, 50)]
    r1, r2 = simulate_pe(genome, 240)
    return [(r1[i:i + 120], r2[i:i + 120], []) for i in range(0, 240, 120)]


@pytest.mark.parametrize("kind", ["se", "pe"])
@pytest.mark.parametrize("mode", list(MAP_MODES))
def test_phases_match_jax_and_engine(world, kind, mode):
    _, jax_side, port = world
    chunks = _chunks(world, kind)
    cutoff = min(2 * port[2].filter_cutoff, 1000)
    mp = MappingParameters(r=150, **MAP_MODES[mode])
    mp.rescue_cutoff = cutoff
    jmp = JaxMapParams(r=150, **MAP_MODES[mode])
    jmp.rescue_cutoff = cutoff
    ap = AlignmentParameters()
    batch = batch_extend.BatchAligner(ap, 64, device="cpu")
    calls = extend_device.packed_calls
    text, stats, isize = run_port(port, chunks, mp, ap, batch)
    want, jstats, jisize = run_python((world[0], *jax_side), chunks, jmp, JaxAlnParams())
    assert text == want
    assert text.count("\n") >= (100 if kind == "se" else 400) * (mode not in ("paf", "U")) // 2
    for f in ("tot_all_tried", "inconsistent_nams", "nam_rescue", "tot_rescued", "n_reads"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert (isize.mu, isize.sigma, isize.V, isize.sample_size) == \
        (jisize.mu, jisize.sigma, jisize.V, jisize.sample_size)
    na, eng = run_engine(port, chunks, mp, ap)
    assert text == na
    c = eng.counters()
    for f in ("tot_all_tried", "inconsistent_nams", "nam_rescue", "tot_rescued"):
        assert c[f] == getattr(stats, f), f
    assert eng.isize() == (float(isize.mu), float(isize.sigma), float(isize.sample_size))
    if mode != "paf":
        assert batch.n_device_jobs > 0 and extend_device.packed_calls > calls


# -- input, randomness, index ------------------------------------------------

def _fq(records):
    return b"".join(f"@{r.name} extra comment\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n"
                    for r in records)


def test_input_buffer_matches_jax_and_native_reader(world, tmp_path):
    """SE, PE (gzipped) and interleaved input with an orphan: the records
    of every chunk equal the JAX InputBuffer's, and the port's engine
    maps them to the SAM its native reader gives (tests/test_engine.py's
    reader test, over the port)."""
    genome, _, port = world
    refs, params, index = port
    se = simulate_se(genome, 130)
    r1, r2 = simulate_pe(genome, 100)
    (tmp_path / "se.fq").write_bytes(_fq(se))
    (tmp_path / "r1.fq.gz").write_bytes(gzip.compress(_fq(r1)))
    (tmp_path / "r2.fq.gz").write_bytes(gzip.compress(_fq(r2)))
    inter = [r for i, (a, b) in enumerate(zip(r1, r2)) for r in ((a,) if i == 57 else (a, b))]
    (tmp_path / "il.fq").write_bytes(_fq(inter))
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    ap = AlignmentParameters()
    for p1, p2, il in ((tmp_path / "se.fq", "", False),
                       (tmp_path / "r1.fq.gz", tmp_path / "r2.fq.gz", False),
                       (tmp_path / "il.fq", "", True)):
        args = (str(p1), str(p2) if p2 else "", 40, il)
        got = list(fastq.InputBuffer(*args).chunks())
        want = list(jfastq.InputBuffer(*args).chunks())
        assert [(ci, [[(r.name, r.seq, r.qual) for r in part] for part in parts])
                for ci, *parts in got] == \
            [(ci, [[(r.name, r.seq, r.qual) for r in part] for part in parts])
             for ci, *parts in want]
        eng = NativeEngine(index, params, refs, ap, mp, "")
        via_python = b"".join(eng.chunk_b_bytes(eng.chunk_a(a, b, c, ci)) for ci, a, b, c in got)
        eng = NativeEngine(index, params, refs, ap, mp, "")
        reader = NativeReader(*args[:2], il, 40)
        parts = []
        for ci, fx, _, _ in reader:
            ch = eng.chunk_a_fx(fx, ci)
            reader.free_chunk(fx)
            parts.append(eng.chunk_b_bytes(ch))
        reader.close()
        assert via_python == b"".join(parts)
        assert via_python.count(b"\n") >= 130
    assert fastq.same_name("p1/1", "p1/2") and not fastq.same_name("READ_A1", "READ_A2")
    assert fastq._cut_name(b"r1 x\ty") == jfastq._cut_name(b"r1 x\ty") == "r1"


def test_minstd_rand_streams_match_jax():
    for seed in (0, 1, 7, 2**31 - 2, 12345):
        g, jg = randomness.MinstdRand(seed), jrandomness.MinstdRand(seed)
        assert [g() for _ in range(200)] == [jg() for _ in range(200)]
        for a, b in ((0, 1), (0, 9), (3, 100), (0, 2**30), (5, 5)):
            assert [randomness.uniform_int(g, a, b) for _ in range(50)] == \
                [jrandomness.uniform_int(jg, a, b) for _ in range(50)]
        lst, jlst = list(range(37)), list(range(37))
        randomness.shuffle(lst, g)
        jrandomness.shuffle(jlst, jg)
        assert lst == jlst
        g.seed(seed + 1)
        jg.seed(seed + 1)
        assert g() == jg()


def test_populate_numpy_matches_native(world, monkeypatch):
    """The numpy index build under RABBITSALIGN_TPU_NO_NATIVE against the
    engine's build (tests/test_engine.py's build test, over the port)."""
    _, _, (refs, params, _) = world
    native_ix = StrobemerIndex(refs, params)
    native_ix.populate(0.0002, 2)
    monkeypatch.setenv(NO_NATIVE, "1")
    with mock.patch.object(StrobemerIndex, "_populate_native", side_effect=AssertionError):
        numpy_ix = StrobemerIndex(refs, params)
        numpy_ix.populate(0.0002, 1)
    for name in ("hashes", "positions", "packed", "randstrobe_start_indices"):
        np.testing.assert_array_equal(getattr(numpy_ix, name), getattr(native_ix, name))
    assert numpy_ix.filter_cutoff == native_ix.filter_cutoff
    assert numpy_ix.hashes.shape[0] > 10000


# -- NAMs from the sharded index -------------------------------------------

@pytest.fixture(scope="module")
def repeats():
    """tests/test_sharded_index.py's repetitive world, and the port's
    index over its arrays cut into 3 shards on the CPU."""
    genome, jrefs, jparams, jindex = _repetitive_world()
    refs = References()
    refs.add("chrR", genome.encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex.from_jax_arrays(
        refs, params, jindex.hashes, jindex.positions, jindex.packed,
        jindex.randstrobe_start_indices, jindex.filter_cutoff, jindex.bits)
    sharded = ShardedIndex(make_mesh(3, "cpu"), index)
    return genome, (jrefs, jparams, jindex), (refs, params, index), sharded


def _key(n):
    return (n.query_start, n.query_end, n.ref_start, n.ref_end, n.ref_id, n.n_hits, n.score,
            n.is_rc)


def test_find_nams_sharded_matches_jax(repeats):
    """tests/test_sharded_index.py:105-173 over the port: reads in unique
    sequence and in the repeat arrays, find_nams_sharded and
    find_nams_rescue_sharded on 3 CPU shards against the JAX package's
    on its 8-device CPU mesh, and against the port's host find_nams."""
    from rabbitsalign_tpu.parallel.sharding import ShardedIndex as JaxShardedIndex
    from rabbitsalign_tpu.parallel.sharding import make_mesh as jax_mesh

    genome, (_, jparams, jindex), (_, params, index), sharded = repeats
    jsh = JaxShardedIndex(jax_mesh(8), jindex)
    assert sharded.k() == index.k() == jsh.k()
    r = random.Random(3)
    rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    n_nams = n_rescue = 0
    for i in range(15):
        st = (20000 + r.randrange(0, 300 * 110)) if i % 3 != 0 else r.randrange(0, len(genome) - 200)
        read = genome[st:st + 150].encode()
        qrs, jqrs = randstrobes_query(read, params), jax_query(read, jparams)
        frac, got = find_nams_sharded(qrs, sharded)
        want = jsharded.find_nams_sharded(jqrs, jsh)
        assert frac == want[0]
        assert [_key(n) for n in got] == [_key(n) for n in want[1]]
        assert [_key(n) for n in got] == [_key(n) for n in nams.find_nams(qrs, index)[1]]
        got = find_nams_rescue_sharded(qrs, sharded, rescue_cutoff)
        want = jsharded.find_nams_rescue_sharded(jqrs, jsh, rescue_cutoff)
        assert [_key(n) for n in got] == [_key(n) for n in want]
        assert [_key(n) for n in got] == \
            [_key(n) for n in nams.find_nams_rescue(qrs, index, rescue_cutoff)]
        n_nams += len(want)
        n_rescue += len(got)
    assert n_nams > 20 and n_rescue > 20


def test_sharded_lookups_end_to_end_sam(repeats):
    """tests/test_sharded_index.py:176-230 over the port: the SE mapping
    core with every lookup served by the sharded index gives the SAM of
    the host-indexed run."""
    genome, _, (refs, params, index), sharded = repeats
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    aligner = Aligner(AlignmentParameters())
    r = random.Random(23)
    records = []
    for i in range(45):
        st = (20000 + r.randrange(0, 300 * 110)) if i % 5 == 1 else r.randrange(0, len(genome) - 200)
        rd = list(genome[st:st + 150])
        for _ in range(r.randrange(0, 4)):
            rd[r.randrange(150)] = r.choice("ACGT")
        records.append(SamRecord(f"e{i}", "".join(rd).encode(), b"I" * 150))

    def run(patched):
        sam = Sam(refs, CIGAR_OPS_M, "", True, False)
        stats = AlignmentStatistics()
        eng = MinstdRand(0)
        eng.seed(0)
        with mock.patch.object(se_mod, "find_nams",
                               (lambda q, ix: find_nams_sharded(q, sharded)) if patched
                               else se_mod.find_nams), \
             mock.patch.object(se_mod, "find_nams_rescue",
                               (lambda q, ix, c: find_nams_rescue_sharded(q, sharded, c))
                               if patched else se_mod.find_nams_rescue):
            for rec in records:
                se_mod.align_SE_read(rec, sam, [], stats, aligner, mp, params, refs, index, eng)
        return sam.take()

    host_sam = run(False)
    assert run(True) == host_sam
    assert host_sam.count("\n") >= 45
