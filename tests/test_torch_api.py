"""The public entry points that no CLI path calls, against the JAX
package's on the CPU, on the same seeded inputs: the engine wrapper's
fills and telemetry (`fill_batch`, `fill_batch_q`, `chunk_b`,
`job_shapes`, `isize_per_chunk`), the availability helpers, the resident,
grouped and unpacked extends, and `sharded_find` and
`data_parallel_extend` over a device list. The port's wrappers take their
plain PyTorch versions for CPU tensors; where the JAX function reaches
Pallas, it is held against its portable twin (`extend_batch_packed_portable`,
`sw_jax.sw_forward` with `traceback_rle`). Every input is integer, so
every comparison is exact."""

from collections import namedtuple

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
from rabbitsalign_tpu.native.engine import NativeEngine as JaxEngine
from rabbitsalign_tpu.ops import extend_device as jx
from rabbitsalign_tpu.ops.extend_portable import extend_batch_packed_portable, traceback_rle
from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu.ops.sw_jax import sw_forward as jax_sw_forward
from rabbitsalign_tpu.parallel import sharding as jsh
from rabbitsalign_tpu_torch import native
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.chain import native_nams
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.native import engine as pe
from rabbitsalign_tpu_torch.native.engine import NativeEngine
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import tb_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams
from rabbitsalign_tpu_torch.parallel import sharding as psh
from rabbitsalign_tpu_torch.pipeline import batched, native_pipeline

from .test_sharded_index import _repetitive_world
from .torch_extend_cases import READ_LEN, bucket_arrays, mixed_pairs, revcomp, sim_read


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions at these sizes run as fast on one thread as on
    eight; torch's intra-op threads would only crowd the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Rec = namedtuple("Rec", "name seq qual")
SCORINGS = [SwParams(2, 8, 12, 1), SwParams(1, 1, 2, 1)]
BATCH = 64  # plan_batches' batch size: several batches a bucket


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 120 kbp genome in two references, 300 SE reads and 150
    PE pairs (a few reads of 220 bp, so jobs reach the (256, 512) bucket), and
    both packages' references and index of it."""
    rng = np.random.RandomState(1601)
    d = tmp_path_factory.mktemp("torch_api")
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 120_000).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1\n" + genome[:100_000] + b"\n>chr2\n" + genome[100_000:] + b"\n")
    se = []
    for i in range(300):
        rd = sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng)
        if i % 25 == 3:  # a long read with a deletion: jobs past the tight bucket
            st = rng.randint(len(genome) - 400)
            rd = genome[st:st + 110] + genome[st + 113:st + 223]
        se.append(Rec(f"s{i}", revcomp(rd) if i % 3 == 1 else rd, b"I" * len(rd)))
    pe_r1, pe_r2 = [], []
    for i in range(150):
        st = rng.randint(len(genome) - 1000)
        insert = int(np.clip(rng.normal(300, 30), 200, 500))
        a = sim_read(genome, st, rng)
        b = revcomp(sim_read(genome, st + insert - READ_LEN, rng))
        pe_r1.append(Rec(f"p{i}", a, b"I" * len(a)))
        pe_r2.append(Rec(f"p{i}", b, b"I" * len(b)))
    ref = str(d / "ref.fa")
    jax_refs = JaxReferences.from_fasta(ref)
    jax_index = JaxIndex(jax_refs, JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    refs = References.from_fasta(ref)
    index = StrobemerIndex.from_jax_arrays(
        refs, IndexParameters.from_read_length(150), jax_index.hashes,
        jax_index.positions, jax_index.packed, jax_index.randstrobe_start_indices,
        jax_index.filter_cutoff, jax_index.bits)
    return {"SE": (se, [], []), "PE": (pe_r1, pe_r2, [])}, jax_refs, jax_index, refs, index


def _engines(world, **mp_kw):
    """(port engine, JAX engine) over the same index, default scoring."""
    _, jax_refs, jax_index, refs, index = world
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff, **mp_kw)
    jmp = JaxMapParams(r=150, **mp_kw)
    jmp.rescue_cutoff = 2 * jax_index.filter_cutoff
    return (NativeEngine(index, index.parameters, refs, AlignmentParameters(), mp),
            JaxEngine(jax_index, jax_index.parameters, jax_refs, JaxAlnParams(), jmp))


def _plans(eng, jeng, chunks, name):
    """Phase A of one chunk in both engines; the port's plans, which must
    equal the JAX engine's."""
    ch = eng.chunk_a(*chunks[name], 0)
    jch = jeng.chunk_a(*chunks[name], 0)
    plans = eng.plan_batches(ch, BATCH)
    jplans = jeng.plan_batches(jch, BATCH)
    assert [p[1:] for p in plans] == [p[1:] for p in jplans]
    for p, jp in zip(plans, jplans):
        np.testing.assert_array_equal(p[0], jp[0])
    return ch, jch, plans


@pytest.fixture
def every_batch(monkeypatch):
    """MIN_DEVICE_JOBS 1 in both engines: every leftover becomes a batch."""
    monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", 1)
    monkeypatch.setattr(JaxEngine, "MIN_DEVICE_JOBS", 1)


def _jobs_of_q(buf_q, ref_codes, Q, T):
    """(q_t, t_t, qlen, tlen) of a fill_batch_q buffer, the targets cut from
    the genome's codes by hand: the jobs `pack_input` packs."""
    lens = buf_q[Q:Q + 8].astype(np.int64)
    qlen = (lens[0] | (lens[1] << 8)).astype(np.int32)
    tlen = (lens[2] | (lens[3] << 8)).astype(np.int32)
    tstart = lens[4] | (lens[5] << 8) | (lens[6] << 16) | (lens[7] << 24)
    t_t = np.full((T, buf_q.shape[1]), 4, np.uint8)
    for b in range(buf_q.shape[1]):
        window = ref_codes[tstart[b]:tstart[b] + tlen[b]]
        t_t[:window.shape[0], b] = window
    return buf_q[:Q], t_t, qlen, tlen


@pytest.mark.parametrize("name", ["SE", "PE"])
def test_fills_match_jax_and_pack_input(world, every_batch, name):
    """`fill_batch` and `fill_batch_q` rows equal the JAX engine's on every
    planned batch, and `fill_batch` equals `pack_input` of the jobs that
    `fill_batch_q` describes (targets cut from `ref_codes`)."""
    eng, jeng = _engines(world)
    ch, jch, plans = _plans(eng, jeng, world[0], name)
    assert {p[1] for p in plans} >= ({152, 256} if name == "SE" else {152})
    ref_codes = eng.ref_codes()
    np.testing.assert_array_equal(ref_codes, jeng.ref_codes())
    for idxs, Q, T, B, _ in plans:
        buf = eng.fill_batch(ch, idxs, B, Q, T)
        buf_q = eng.fill_batch_q(ch, idxs, B, Q)
        assert buf.shape == (Q + T + 4, B) and buf_q.shape == (Q + 8, B)
        np.testing.assert_array_equal(buf, jeng.fill_batch(jch, idxs, B, Q, T))
        np.testing.assert_array_equal(buf_q, jeng.fill_batch_q(jch, idxs, B, Q))
        np.testing.assert_array_equal(buf, px.pack_input(*_jobs_of_q(buf_q, ref_codes, Q, T)))
        np.testing.assert_array_equal(buf, jx.pack_input(*_jobs_of_q(buf_q, ref_codes, Q, T)))


def _four_extends(buf, buf_q, buf_q2, genome, Q, T, sw, sub):
    """The port's resident (q), resident (q2) and grouped extends on the
    CPU, and the JAX package's `extend_batch_packed_portable`, as numpy."""
    ref = px.resident_ref_codes(genome, "cpu")
    got = [px.extend_batch_packed_resident(torch.from_numpy(buf_q), ref, Q, T, sw, sub),
           px.extend_batch_packed_resident_q2(torch.from_numpy(buf_q2), ref, Q, T, sw, sub),
           px.extend_batch_packed_grouped(torch.from_numpy(buf), Q, T, sw, sub)]
    want = np.asarray(extend_batch_packed_portable(buf, Q, T, JaxSwParams(*sw)))
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("sw", SCORINGS, ids=["default", "flat"])
def test_resident_and_grouped_extends_match_jax(world, every_batch, sw):
    """On the engine's SE and PE jobs, at the first planned batch of each
    bucket and at the last (a leftover) batch: the resident extend of
    `fill_batch_q`, the q2 extend of `fill_batch_q2` and the grouped extend
    of `fill_batch` (at the plan's `sub`, which divides B, and at a `sub`
    that does not) equal the JAX `extend_batch_packed_portable` of
    `fill_batch` byte for byte, and count their calls."""
    eng, jeng = _engines(world)
    genome = eng.ref_codes()
    counts = px.resident_calls, px.grouped_calls, px.calls
    n = 0
    for name in ("SE", "PE"):
        ch, _, plans = _plans(eng, jeng, world[0], name)
        seen = set()
        for i, (idxs, Q, T, B, sub) in enumerate(plans):
            if (Q, T) in seen and i != len(plans) - 1:
                continue
            seen.add((Q, T))
            buf = eng.fill_batch(ch, idxs, B, Q, T)
            buf_q = eng.fill_batch_q(ch, idxs, B, Q)
            buf_q2 = eng.fill_batch_q2(ch, idxs, B, Q)
            for s in (sub, 7):
                got, want = _four_extends(buf, buf_q, buf_q2, genome, Q, T, sw, s)
                for g in got:
                    np.testing.assert_array_equal(g, want)
                n += 1
            assert B % sub == 0 and B % 7
    assert (px.resident_calls, px.grouped_calls, px.calls) == tuple(c + n for c in counts)


@pytest.mark.parametrize("sw", SCORINGS, ids=["default", "flat"])
def test_resident_extend_at_the_genome_end_matches_jax(sw):
    """Windows that start 100, 40 and 1 codes before the genome's end, and
    one of one code at its last code, read code 4 past it: both resident
    layouts equal the JAX portable extend of the windows cut from
    `pack_ref_pages`. Their queries continue the genome's tail with its
    last base, so reading that base past the end would change the
    alignments."""
    Q, T = 152, 256
    rng = np.random.RandomState(7)
    genome = rng.randint(0, 4, 5000).astype(np.uint8)
    n = genome.shape[0]
    ends = [n - 100, n - 40, n - 1]
    pairs = mixed_pairs(Q, T, 8, seed=3) + [
        (np.concatenate([genome[st:], np.full(40, genome[-1], np.uint8)]), genome[st:])
        for st in ends] + [(genome[-1:], genome[-1:])]
    tstart = np.array([rng.randint(0, n - T) for _ in range(8)] + ends + [n - 1], np.int64)
    B = len(pairs)
    qlen = np.array([q.shape[0] for q, _ in pairs], np.int32)
    tlen = np.array([t.shape[0] for _, t in pairs[:8]] + [T] * 3 + [1], np.int32)
    q_t = bucket_arrays(pairs, Q, T)[0]
    buf_q = np.zeros((Q + 8, B), np.uint8)
    buf_q[:Q] = q_t
    for i, v in enumerate((qlen & 0xFF, qlen >> 8, tlen & 0xFF, tlen >> 8)):
        buf_q[Q + i] = v
    for i in range(4):
        buf_q[Q + 4 + i] = (tstart >> (8 * i)) & 0xFF
    buf_q2 = _q2_of(q_t, qlen, buf_q[Q:], Q)
    page = jx.pack_ref_pages(genome)[0]
    t_t = np.full((T, B), 4, np.uint8)
    for b in range(B):
        t_t[:tlen[b], b] = page[tstart[b]:tstart[b] + tlen[b]]
    assert (t_t[40:, -3] == 4).all() and t_t[0, -1] == genome[-1]
    buf = jx.pack_input(q_t, t_t, qlen, tlen)
    got, want = _four_extends(buf, buf_q, buf_q2, genome, Q, T, sw, B)
    for g in got:
        np.testing.assert_array_equal(g, want)
    assert (px.unpack_output(want)[0] > 0).any()


def _q2_of(q_t, qlen, tail, Q):
    """The q2 layout of (Q, B) query codes and the 8 tail rows."""
    Qp, Qm = (Q + 3) // 4, (Q + 7) // 8
    B = q_t.shape[1]
    buf = np.zeros((Qp + Qm + 8, B), np.uint8)
    for b in range(B):
        r = np.arange(qlen[b])
        q = q_t[:qlen[b], b]
        np.bitwise_or.at(buf[:, b], r >> 2, ((q & 3) << ((r & 3) << 1)).astype(np.uint8))
        np.bitwise_or.at(buf[:, b], Qp + (r >> 3),
                         np.where(q >= 4, 1 << (r & 7), 0).astype(np.uint8))
    buf[Qp + Qm:] = tail
    return buf


def test_grouped_extend_refuses_a_bad_buffer():
    buf = torch.zeros((10, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 buffer"):
        px.extend_batch_packed_grouped(buf, 4, 4, SCORINGS[0], 2)
    with pytest.raises(ValueError, match="sub must be positive"):
        px.extend_batch_packed_grouped(torch.zeros((12, 4), dtype=torch.uint8), 4, 4,
                                       SCORINGS[0], 0)
    with pytest.raises(ValueError, match="uint8 buffer"):
        px.extend_batch_packed_resident(buf, torch.zeros(8, dtype=torch.uint8), 4, 4,
                                        SCORINGS[0], 2)


@pytest.mark.parametrize("sw", SCORINGS, ids=["default", "flat"])
def test_extend_batch_device_matches_jax(sw):
    """`extend_batch_device` equals JAX `sw_jax.sw_forward` followed by
    `extend_portable.traceback_rle` (the twins of the Pallas kernels its
    JAX counterpart runs), and its runs and meta, packed, equal the packed
    extend of the same pairs."""
    Q, T = 152, 256
    q_t, t_t, qlen, tlen = bucket_arrays(mixed_pairs(Q, T, 40, seed=11), Q, T)
    calls = px.device_calls
    got = px.extend_batch_device(*(torch.from_numpy(x) for x in (q_t, t_t, qlen, tlen)), sw)
    assert px.device_calls == calls + 1
    js, jte, jqe, jd = jax_sw_forward(q_t.T.copy(), t_t.T.copy(), qlen, tlen, JaxSwParams(*sw))
    want = (js, jte, jqe, *traceback_rle(jd, js, jte, jqe))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    runs_op, runs_len, meta = got[3:]
    packed = tb_cuda.pack_rle_output(runs_op, runs_len, *got[:3], meta)
    buf = torch.from_numpy(px.pack_input(q_t, t_t, qlen, tlen))
    assert torch.equal(packed, px.extend_batch_packed(buf, Q, T, sw))


@pytest.mark.parametrize("min_jobs", [None, 1], ids=["default", "one"])
def test_job_shapes_match_jax(world, monkeypatch, min_jobs):
    """After the same SE and PE chunks, `job_shapes` equals the JAX
    engine's: the buckets' counts, the unbucketed jobs, the leftovers sent
    to the host (nonzero at MIN_DEVICE_JOBS 48 on these small chunks, zero
    at 1) and both histograms; the counts and the histograms sum to the
    jobs."""
    if min_jobs is not None:
        monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", min_jobs)
        monkeypatch.setattr(JaxEngine, "MIN_DEVICE_JOBS", min_jobs)
    eng, jeng = _engines(world)
    n_jobs = 0
    for name in ("SE", "PE"):
        n_jobs += _plans(eng, jeng, world[0], name)[0].n_jobs
    got, want = eng.job_shapes(), jeng.job_shapes()
    assert set(got) == set(want)
    for k in ("buckets", "unbucketed", "small_to_host"):
        assert got[k] == want[k], k
    for k in ("qlen_hist_32", "tlen_hist_32"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        assert int(got[k].sum()) == n_jobs
    assert sum(n for _, _, n in got["buckets"]) + got["unbucketed"] == n_jobs
    assert (got["small_to_host"] > 0) == (min_jobs is None)


@pytest.mark.parametrize("pe_ref_async", [False, True], ids=["cumulative", "per-chunk"])
def test_isize_and_chunk_b_match_jax(world, pe_ref_async):
    """After two PE chunks through both engines (host alignment),
    `isize_per_chunk` says which estimator `isize` reports, and both equal
    the JAX engine's; `chunk_b` is `chunk_b_bytes` decoded, and equals the
    JAX engine's `chunk_b`."""
    eng, jeng = _engines(world, pe_ref_async=pe_ref_async)
    r1, r2, r3 = world[0]["PE"]
    other, _ = _engines(world, pe_ref_async=pe_ref_async)
    for ci, part in enumerate((slice(0, 80), slice(80, None))):
        recs = (r1[part], r2[part], r3)
        text = eng.chunk_b(eng.chunk_a(*recs, ci))
        assert isinstance(text, str)
        assert text == jeng.chunk_b(jeng.chunk_a(*recs, ci))
        assert text == other.chunk_b_bytes(other.chunk_a(*recs, ci)).decode()
    assert eng.isize_per_chunk() is pe_ref_async is jeng.isize_per_chunk()
    assert eng.isize() == jeng.isize()
    assert eng.isize()[2] > 0


@pytest.fixture(scope="module")
def shard_world():
    """The repetitive world of tests/test_sharded_index.py in both
    packages, and keys: indexed hashes, random misses and the smallest
    hash (unreachable through the bucket table)."""
    genome, _, _, jax_index = _repetitive_world()
    refs = References()
    refs.add("chrR", genome.encode())
    index = StrobemerIndex.from_jax_arrays(
        refs, IndexParameters.from_read_length(150), jax_index.hashes, jax_index.positions,
        jax_index.packed, jax_index.randstrobe_start_indices, jax_index.filter_cutoff,
        jax_index.bits)
    rng = np.random.RandomState(5)
    h = np.asarray(index.hashes)
    keys = np.concatenate([h[rng.randint(0, h.shape[0], 300)],
                           rng.randint(0, 2**63, 100).astype(np.uint64), h[:1], h[-1:]])
    return index, jax_index, keys


def _jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    return jsh.make_mesh(n)


@pytest.mark.parametrize("cap", [None, 3])
def test_sharded_find_matches_jax(shard_world, cap):
    """`sharded_find` over four CPU entries equals JAX `sharded_find` on a
    4-device CPU mesh and `StrobemerIndex.find`, misses and the smallest
    hash's bucket quirk included."""
    index, jax_index, keys = shard_world
    got = psh.sharded_find(["cpu"] * 4, index, keys, cap)
    want = np.asarray(jsh.sharded_find(_jax_mesh(4), jax_index, keys, cap))
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, index.find(keys))
    assert (got == -1).sum() >= 100 and got[-2] == index.find(keys[-2:-1])[0]


@pytest.mark.parametrize("sw", SCORINGS, ids=["default", "flat"])
def test_data_parallel_extend_matches_jax(sw):
    """`data_parallel_extend` over four CPU entries equals the JAX one on a
    4-device CPU mesh (batch-first codes, the cells as an int64 psum), and
    over one entry and over one device named twice."""
    Q, T, B = 96, 160, 32
    q_t, t_t, qlen, tlen = bucket_arrays(mixed_pairs(Q, T, B, seed=21), Q, T)
    q, t = q_t.T.copy(), t_t.T.copy()
    want = [np.asarray(x) for x in jsh.data_parallel_extend(_jax_mesh(4), JaxSwParams(*sw), q,
                                                            t, qlen, tlen)]
    assert int(want[3]) == int((qlen.astype(np.int64) * tlen).sum())
    for devices in (["cpu"] * 4, ["cpu"], [torch.device("cpu")] * 2):
        got = psh.data_parallel_extend(devices, sw, q, t, qlen, tlen)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        assert got[3].dtype == torch.int64 and int(got[3]) == int(want[3])
    with pytest.raises(ValueError, match="does not split"):
        psh.data_parallel_extend(["cpu"] * 3, sw, q, t, qlen, tlen)


def test_availability_helpers(monkeypatch):
    """`engine_available`, `native_available` and
    `native_pipeline_available` are true with the engine, and false only
    under RABBITSALIGN_TPU_NO_NATIVE; the Python mapper's
    `native_available` is the same function, and the pipeline module
    re-exports `engine_available`."""
    helpers = (pe.engine_available, native_nams.native_available,
               native_pipeline.native_pipeline_available)
    assert batched.native_available is native_nams.native_available
    assert native_pipeline.engine_available is pe.engine_available
    assert all(f() is True for f in helpers)
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    assert all(f() is False for f in helpers)
    monkeypatch.setenv(native.NO_NATIVE_ENV, "")
    assert all(f() is True for f in helpers)
