"""`--shard-index` on the CPU: the port's hash-sharded index
(rabbitsalign_tpu_torch/parallel/sharding.py, the plain versions of the
`find_runs.cu` kernels on CPU tensors) against rabbitsalign_tpu's, which
runs on the 8-device CPU mesh of tests/conftest.py: the shard arrays, both
lookups and the compacted run records element-equal on an 8-shard index;
and the `--shard-index` SAM, SE and PE with rescue, equal to the port's
default run and to rabbitsalign_tpu's `--shard-index` CLI apart from @PG,
with the engine's feed_miss at 0."""

import random

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.parallel import sharding as jsh
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.parallel import sharding as psh
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from . import torch_cuda_emu
from .test_sharded_index import _repetitive_world
from .torch_gather_lanes import K_WARP_RUN, RunsIndex, gather_lanes
from .util import random_dna

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
LOOKUP_KEYS = ("position", "count", "filtered", "run_positions", "run_packed")


def _port_index(refs, jax_index):
    return StrobemerIndex.from_jax_arrays(
        refs, IndexParameters.from_read_length(150), jax_index.hashes, jax_index.positions,
        jax_index.packed, jax_index.randstrobe_start_indices, jax_index.filter_cutoff,
        jax_index.bits)


def _jax_mesh(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    return jsh.make_mesh(n)


@pytest.fixture(scope="module")
def world():
    """The repetitive world of tests/test_sharded_index.py (tandem repeats
    that make filtered runs and rescue), both packages' indexes of it, and
    both packages' 8-shard indexes."""
    genome, jax_refs, _, jax_index = _repetitive_world()
    refs = References()
    refs.add("chrR", genome.encode())
    index = _port_index(refs, jax_index)
    return (genome, refs, index, jax_index,
            psh.ShardedIndex(psh.make_mesh(8, "cpu"), index),
            jsh.ShardedIndex(_jax_mesh(8), jax_index))


def _assert_lookup_equal(got, want):
    assert set(got) == set(want)
    for k in LOOKUP_KEYS:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


class _Stub:
    """An index of given hashes, with the bucket table StrobemerIndex
    builds (bucket b covers the hashes whose top `bits` equal b)."""

    def __init__(self, hashes, positions, packed, bits, filter_cutoff):
        self.hashes, self.positions, self.packed = hashes, positions, packed
        self.bits, self.filter_cutoff = bits, filter_cutoff
        tops = (hashes >> np.uint64(64 - bits)).astype(np.int64)
        self.randstrobe_start_indices = np.searchsorted(
            tops, np.arange((1 << bits) + 1)).astype(np.uint64)

    def k(self):  # the JAX package's ShardedIndex reads it
        return 20


def _random_stub(rng):
    n_runs = int(rng.randint(1, 200))
    lens = rng.geometric(0.4, n_runs)
    long_ix = rng.rand(n_runs) < 0.05
    lens[long_ix] += rng.randint(30, 120, int(long_ix.sum()))
    vals = np.unique(rng.randint(0, 2**63, n_runs).astype(np.uint64) * np.uint64(2))
    hashes = np.repeat(vals, lens[: vals.shape[0]]).astype(np.uint64)
    n = hashes.shape[0]
    return _Stub(hashes, rng.randint(0, 2**32, n).astype(np.uint32),
                 rng.randint(0, 2**32, n).astype(np.uint32), int(rng.randint(2, 12)),
                 int(rng.randint(1, 40)))


def _sentinel_stub():
    """Small runs, then a long run of the 0xFF..F hash at the top, long
    enough that shard cuts collapse onto its start and the last shards
    come out empty (tests/test_sharded_index.py:379)."""
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    hashes = np.concatenate([np.repeat(np.uint64(5), 2),
                             np.repeat(np.uint64(1) << np.uint64(40), 3),
                             np.repeat(np.uint64(7) << np.uint64(60), 1), np.repeat(top, 10)])
    n = hashes.shape[0]
    return _Stub(hashes, np.arange(n, dtype=np.uint32), (np.arange(n, dtype=np.uint32) << 8) | 1,
                 4, 30)


def _keys(stub, rng):
    """Run heads and tails, off-by-one neighbours, misses, 0, the
    sentinel, and the globally smallest hash (the bucket quirk)."""
    h = stub.hashes
    picks = rng.randint(0, h.shape[0], 80)
    return np.concatenate([rng.randint(0, 2**63, 40).astype(np.uint64), h[picks],
                           h[picks] + np.uint64(1), h[picks] - np.uint64(1),
                           np.array([0, 2**64 - 1, h[0], h[-1]], np.uint64)])


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_shard_arrays_match_jax(world, n_shards):
    """shard_index_by_hash (tests/test_ops.py:79's heavy duplication, and
    the world's index) and shard_bounds equal the JAX package's, element
    for element (the JAX package's reachable flags aside: the port's
    lookup takes them from the bucket table)."""
    rng = np.random.RandomState(3)
    base = np.sort(rng.randint(0, 50, 997).astype(np.uint64))
    cases = [(base, np.arange(997, dtype=np.uint32), np.zeros(997, np.uint32), None)]
    _, _, index, jax_index, _, _ = world
    cases.append((index.hashes, index.positions, index.packed, jsh._bucket_reachable(jax_index)))
    for hashes, positions, packed, reach in cases:
        got = psh.shard_index_by_hash(hashes, positions, packed, n_shards)
        want = jsh.shard_index_by_hash(hashes, positions, packed, n_shards, reach)
        for g, w in zip(got, want[:3] + want[4:]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(psh.shard_bounds(hashes, n_shards),
                                      jsh.shard_bounds(hashes, n_shards))
        flat = got[0][got[0] != psh.SENTINEL]  # no run split across shards
        np.testing.assert_array_equal(flat, hashes)


@pytest.mark.parametrize("lookup", ["find_runs", "find_runs_routed"])
@pytest.mark.parametrize("cap", ["filter_cutoff", 4])
def test_lookups_match_jax(world, lookup, cap):
    """Both lookups of the port's 8-shard index equal both of the JAX
    package's on the repetitive world: real hashes (repetitive runs,
    filtered ones, runs longer than a small cap whose rows carry the
    first `cap` records), misses, and the smallest hash (the bucket
    quirk: absent)."""
    _, _, index, jax_index, port_si, jax_si = world
    r = random.Random(31)
    n = index.hashes.shape[0]
    keys = np.array([int(index.hashes[r.randrange(n)]) for _ in range(400)]
                    + [r.getrandbits(64) for _ in range(100)] + [int(index.hashes[0])],
                    dtype=np.uint64)
    cap = port_si.filter_cutoff if cap == "filter_cutoff" else cap
    got = getattr(port_si, lookup)(keys, cap)
    _assert_lookup_equal(got, jax_si.find_runs(keys, cap))
    _assert_lookup_equal(got, jax_si.find_runs_routed(keys, cap))
    assert got["position"][-1] == -1 == jax_index.find(keys[-1:])[0]
    assert got["filtered"].any() and (got["count"] > cap).any() and (got["position"] < 0).any()


@pytest.mark.parametrize("case", ["sentinel", "random"])
def test_lookups_and_compaction_on_stub_indexes_match_jax(case):
    """Synthetic indexes at 1 to 8 shards (the sentinel hash's long top
    run with empty trailing shards; random indexes with skewed run
    lengths and bucket widths): both lookups at a small cap, and the
    compacted run records, equal the JAX package's."""
    rng = np.random.RandomState(0xF00D)
    stubs = [_sentinel_stub()] if case == "sentinel" else [_random_stub(rng) for _ in range(6)]
    for trial, stub in enumerate(stubs):
        n_shards = 8 if case == "sentinel" else 1 + trial
        port_si = psh.ShardedIndex(psh.make_mesh(n_shards, "cpu"), stub)
        jax_si = jsh.ShardedIndex(_jax_mesh(n_shards), stub)
        np.testing.assert_array_equal(port_si._start_hash, jax_si._start_hash)
        keys = _keys(stub, rng)
        cap = int(rng.randint(1, 12))
        for lookup in ("find_runs", "find_runs_routed"):
            _assert_lookup_equal(getattr(port_si, lookup)(keys, cap),
                                 getattr(jax_si, lookup)(keys, cap))
        _assert_compact_equal(port_si.find_runs_compact(keys), _jax_compaction(jax_si, keys))
    if case == "sentinel":
        assert (port_si._start_hash == psh.SENTINEL).sum() > 1  # empty shards share it
        res = port_si.find_runs_routed(np.array([2**64 - 1], np.uint64), 30)
        assert res["position"][0] == 6 and res["count"][0] == 10  # found, with its run


@pytest.mark.parametrize("layout", ["dense", "compacted", "dst<0"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_gather_lane_replay_matches_plain(n_shards, layout):
    """The lane-by-lane replay of gather_runs_kernel (tests/
    torch_gather_lanes.py: short runs by their thread, long runs by the
    warp) writes what `gather_runs_plain` writes, shard by shard, on the
    random, sentinel and run-length stubs: the dense (NQ, cap) rows, the
    compacted rows at an exclusive cumsum, and the same with some keys'
    dst < 0 (skipped)."""
    import torch

    from rabbitsalign_tpu_torch.ops.shard_find import find_runs_plain, gather_runs_plain

    rng = np.random.RandomState(n_shards)
    cap = 40
    stubs = [_random_stub(rng), _random_stub(rng), _sentinel_stub(), RunsIndex(cap)]
    seen = {"thread_rows": 0, "warp_rows": 0}
    for stub in stubs:
        si = psh.ShardedIndex(psh.make_mesh(n_shards, "cpu"), stub)
        keys = _keys(stub, rng)
        q = torch.from_numpy(keys.view(np.int64))
        for s in range(n_shards):
            h, p, k = si._shards[s]
            gpos, count = find_runs_plain(h, si.shard_sizes[s], si.starts[s], si._buckets,
                                          si.bits, q)
            n = count.clamp(max=cap)
            if layout == "dense":
                dst, rows = None, keys.size * cap
            else:
                dst = torch.cumsum(n, 0) - n
                if layout == "dst<0":
                    dst[torch.from_numpy(rng.rand(keys.size) < 0.3)] = -1
                rows = max(int(n.sum()), 1)
            want = [torch.zeros(rows, dtype=torch.int32) for _ in range(2)]
            gather_runs_plain(p, k, gpos, count, si.starts[s], cap, dst, *want)
            got = [np.zeros(rows, np.int32) for _ in range(2)]
            st = gather_lanes(p.numpy(), k.numpy(), gpos.numpy(), count.numpy(), si.starts[s],
                              cap, None if dst is None else dst.numpy(), *got)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())
            for key in seen:
                seen[key] += st[key]
    assert seen["thread_rows"] > 0 and seen["warp_rows"] > 2 * cap


@pytest.fixture(scope="module")
def runs_emu(tmp_path_factory):
    """csrc/find_runs.cu built for the host (tests/torch_cuda_emu.py)."""
    from rabbitsalign_tpu_torch.ops import cuda_build

    lib = torch_cuda_emu.build("find_runs", tmp_path_factory.mktemp("runs_emu"))
    cuda_build.declare(lib, ("find_runs_launch", "gather_runs_launch"))
    return lib


@pytest.mark.parametrize("n_shards", [1, 3])
def test_find_runs_kernel_source_on_host_matches_plain(runs_emu, n_shards):
    """find_runs.cu's own source, run on the host by the thread-a-lane
    emulation: its search equals `find_runs_plain` with the whole bucket
    table and with a table trimmed to rows top0 onwards, and its gather
    `gather_runs_plain` at caps 3 and 40, dense, at the pod's offsets and
    with keys skipped, on the random, sentinel and run-length stubs."""
    import torch

    from rabbitsalign_tpu_torch.ops.shard_find import find_runs_plain, gather_runs_plain

    rng = np.random.RandomState(10 + n_shards)
    for stub in (_random_stub(rng), _sentinel_stub(), RunsIndex(40)):
        si = psh.ShardedIndex(psh.make_mesh(n_shards, "cpu"), stub)
        q = torch.from_numpy(_keys(stub, rng).view(np.int64))
        for s in range(n_shards):
            h, p, k = si._shards[s]
            size, start = si.shard_sizes[s], si.starts[s]
            for top0 in (0, 1):
                b = si._buckets[top0:].contiguous()
                want = find_runs_plain(h, size, start, b, si.bits, q, top0)
                got = [torch.empty_like(q), torch.empty_like(q)]
                assert runs_emu.find_runs_launch(
                    h.data_ptr(), h.numel(), size, start, b.data_ptr(), b.numel(), si.bits, top0,
                    q.data_ptr(), q.numel(), got[0].data_ptr(), got[1].data_ptr(), None) == 0
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            gpos, count = want
            for cap in (3, 40):
                width = count.clamp(max=cap)
                ends = torch.cumsum(width, 0)
                for dst in (None, ends - width, torch.where(q % 3 == 0, -1, ends - width)):
                    rows = q.numel() * cap if dst is None else max(int(ends[-1]), 1)
                    outs = [torch.zeros(rows, dtype=torch.int32) for _ in range(4)]
                    gather_runs_plain(p, k, gpos, count, start, cap, dst, *outs[:2])
                    assert runs_emu.gather_runs_launch(
                        p.data_ptr(), k.data_ptr(), gpos.data_ptr(), count.data_ptr(), start,
                        None if dst is None else dst.data_ptr(), q.numel(), cap,
                        outs[2].data_ptr(), outs[3].data_ptr(), None) == 0
                    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def test_run_stub_lengths():
    """The run-length stub holds the runs the gather test needs: 1, 31,
    32, 33 rows, runs past the cap, and short ones on either side of the
    warp threshold."""
    stub = RunsIndex(40)
    _, lens = np.unique(stub.hashes, return_counts=True)
    assert {1, 31, 32, 33, K_WARP_RUN, K_WARP_RUN + 1} <= set(lens.tolist())
    assert (lens > 40).sum() == 2


def _jax_compaction(jax_si, hashes):
    """The host compaction of rabbitsalign_tpu's _shard_chunk_a
    (pipeline/native_pipeline.py:337-357) over its routed lookup."""
    fc = int(jax_si.filter_cutoff)
    res = jax_si.find_runs_routed(hashes, fc)
    cnt, filt = res["count"], res["filtered"]
    rows = np.flatnonzero((cnt > 0) & ~filt)
    widths = cnt[rows]
    run_off = np.full(max(hashes.shape[0], 1), -1, np.int64)
    run_pos = np.zeros(1, np.uint32)
    run_packed = np.zeros(1, np.uint32)
    if rows.size:
        run_off[rows] = np.concatenate(([0], np.cumsum(widths)[:-1]))
        colmask = np.arange(fc)[None, :] < widths[:, None]
        run_pos = np.ascontiguousarray(res["run_positions"][rows][colmask], dtype=np.uint32)
        run_packed = np.ascontiguousarray(res["run_packed"][rows][colmask], dtype=np.uint32)
    return {"count": cnt, "filtered": filt, "run_off": run_off, "run_positions": run_pos,
            "run_packed": run_packed}


def _assert_compact_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_compacted_run_records_match_jax_host_compaction(world, n_shards):
    """The arrays the engine's run feed receives: the port builds them on
    the device (`find_runs_compact`), the JAX package compacts dense
    (NQ, filter_cutoff) matrices on the host; equal for a chunk's
    host-seeded strobes (forward and reverse) plus misses."""
    from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

    genome, _, index, _, port_si, jax_si = world
    if n_shards == 1:
        port_si = psh.ShardedIndex(psh.make_mesh(1, "cpu"), index)
    r = random.Random(4)
    hashes = []
    for i in range(60):
        st = (20000 + r.randrange(300 * 110)) if i % 3 == 1 else r.randrange(len(genome) - 200)
        hashes.append(randstrobes_query(genome[st:st + 150].encode(), index.parameters).hash)
    hashes.append(np.array([r.getrandbits(64) for _ in range(50)], dtype=np.uint64))
    hashes = np.concatenate(hashes)
    got = port_si.find_runs_compact(hashes)
    want = _jax_compaction(jax_si, hashes)
    _assert_compact_equal(got, want)
    assert (got["run_off"] >= 0).sum() > 500 and got["filtered"].any()


@pytest.fixture(scope="module")
def reads(world, tmp_path_factory):
    """FASTA of the repetitive world, and SE reads and PE pairs of it with
    a share in the tandem-repeat block (repetitive seeds: rescue), random
    junk and reverse complements (tests/test_sharded_index.py:225)."""
    genome = world[0]
    d = tmp_path_factory.mktemp("torch_shard")
    (d / "ref.fa").write_bytes(b">chrR\n" + genome.encode() + b"\n")
    r = random.Random(5)
    unit_region = (20000, 20000 + 300 * 120)

    def read_at(st):
        s = list(genome[st : st + 150])
        s[r.randrange(150)] = r.choice("ACGT")
        return "".join(s)

    def fastq(path, lines):
        path.write_bytes(b"".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n".encode() for n, s in lines))

    se = []
    for i in range(260):
        if i % 9 == 1:
            se.append((f"j{i}", "".join(r.choice("ACGT") for _ in range(150))))
            continue
        rd = read_at(r.randrange(*unit_region) if i % 4 == 0 else r.randrange(len(genome) - 200))
        se.append((f"s{i}", "".join(COMP[c] for c in reversed(rd)) if i % 3 == 2 else rd))
    fastq(d / "se.fq", se)
    r1, r2 = [], []
    for i in range(120):
        st = r.randrange(*unit_region) if i % 5 == 0 else r.randrange(len(genome) - 900)
        ins = max(180, min(600, int(r.gauss(300, 50))))
        b = "".join(COMP[c] for c in reversed(genome[st + ins - 150 : st + ins]))
        if i % 11 == 3:
            b = "".join(r.choice("ACGT") for _ in range(150))
        r1.append((f"p{i}/1", read_at(st)))
        r2.append((f"p{i}/2", b))
    fastq(d / "r1.fq", r1)
    fastq(d / "r2.fq", r2)
    return d


def _without_pg(path) -> bytes:
    return b"".join(line for line in open(path, "rb") if not line.startswith(b"@PG"))


MODES = {
    "se-t1": (["se.fq"], ["-t", "1"]),
    "pe-t1": (["r1.fq", "r2.fq"], ["-t", "1"]),
    "se-t2": (["se.fq"], ["-t", "2"]),
    "pe-deterministic-t2": (["r1.fq", "r2.fq"], ["--deterministic", "-t", "2"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_shard_index_cli_matches_default_and_jax(reads, mode, capsys):
    """`--shard-index --device cpu` (one shard on the CPU, the lookup's
    plain versions, the extend's plain versions) against the port's
    default run and rabbitsalign_tpu's `--shard-index` (its 8-device CPU
    mesh): the same SAM apart from @PG; no feed misses, and rescue ran on
    the repeat reads."""
    files, extra = MODES[mode]
    argv = [str(reads / "ref.fa"), *(str(reads / f) for f in files), "--tpu-batch", "64",
            "--chunk-size", "48", *extra]
    out = {name: reads / f"{mode}.{name}.sam" for name in ("default", "shard", "jax")}
    assert port_main(argv + ["--device", "cpu", "-o", str(out["default"])]) == 0
    capsys.readouterr()
    assert port_main(argv + ["--device", "cpu", "--shard-index", "-o", str(out["shard"])]) == 0
    log = capsys.readouterr().err
    assert "Sharded index: 1 shard(s) on cpu" in log
    assert "feed misses 0" in log
    assert int(log.split("Tried NAM rescue: ")[1].split()[0]) > 0
    assert jax_main(argv + ["--shard-index", "-o", str(out["jax"])]) == 0
    shard = _without_pg(out["shard"])
    assert shard == _without_pg(out["default"])
    assert shard == _without_pg(out["jax"])
    assert len(shard.splitlines()) >= 240


@pytest.mark.parametrize("files", [("se.fq", ""), ("r1.fq", "r2.fq")], ids=["se", "pe"])
def test_run_feed_arrays_match_jax(world, reads, files):
    """Both packages' `_shard_chunk_a` on 8-shard indexes, chunk by chunk:
    the strobes, the first lookup's compacted run records and the rescue's
    records that reach the engine's `chunk_a_fx_runs` are the same bytes,
    and rescue records were fed."""
    from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
    from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline as JaxPipeline

    _, refs, index, jax_index, port_si, jax_si = world
    jax_mp = JaxMapParams(r=150)
    jax_mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    mp = MappingParameters(r=150, rescue_cutoff=jax_mp.rescue_cutoff)
    pipes = [JaxPipeline(jax_index, jax_index.parameters, _repetitive_world()[1], JaxAlnParams(),
                         jax_mp, use_device=False, shard_index=True, sharded_index=jax_si),
             pnp.NativePipeline(index, index.parameters, refs, AlignmentParameters(), mp,
                                use_device=False, device="cpu", shard_index=True,
                                sharded_index=port_si)]
    fed = [[], []]
    for pipe, arrays in zip(pipes, fed):
        real = pipe.engine.chunk_a_fx_runs

        def record(fx, ci, *a, real=real, arrays=arrays):
            arrays.append([np.array(x) for x in a])
            return real(fx, ci, *a)

        pipe.engine.chunk_a_fx_runs = record
        pipe.map_file(*(str(reads / f) if f else "" for f in files), False, 48, lambda b: None)
    assert len(fed[1]) == len(fed[0]) >= 3
    for want, got in zip(*fed):
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert sum(int((a[11] >= 0).sum()) for a in fed[1]) > 0  # rescue records fed


def test_shard_pipelines_on_eight_shards(world, reads):
    """NativePipeline on the 8-shard index and ThreadedNativePipeline (2
    workers, its own one-shard index shared by both) with --no-tpu
    against host lookups, SE and PE: equal bytes, feed_miss 0, rescue ran
    and the sharded lookups were timed."""
    _, refs, index, _, port_si, _ = world
    mp = MappingParameters(r=150, rescue_cutoff=min(2 * index.filter_cutoff, 1000))
    args = (index, index.parameters, refs, AlignmentParameters(), mp)
    for files in (("se.fq", ""), ("r1.fq", "r2.fq")):
        paths = [str(reads / f) if f else "" for f in files]
        host = []
        pnp.NativePipeline(*args, use_device=False).map_file(*paths, False, 48, host.append)
        one = pnp.NativePipeline(*args, use_device=False, device="cpu", shard_index=True,
                                 sharded_index=port_si)
        out = []
        one.map_file(*paths, False, 48, out.append)
        assert b"".join(out) == b"".join(host)
        assert one.counters()["feed_miss"] == 0 and one.counters()["nam_rescue"] > 0
        assert one.timers()["shard_lookup_s"] > 0
        two = pnp.ThreadedNativePipeline(*args, use_device=False, n_workers=2, device="cpu",
                                         deterministic=True, shard_index=True)
        assert two.sharded_index.n_shards == 1
        out = []
        two.map_file(*paths, False, 48, out.append)
        if not files[1]:  # SE bytes do not depend on the worker count
            assert b"".join(out) == b"".join(host)
        assert two.counters()["feed_miss"] == 0


def test_shard_index_rescue_cutoff_above_run_cap(tmp_path):
    """-R can push rescue_cutoff past 1000; the engine's rescue walk stops
    at count > 1000, so runs in (1024, cutoff] must not be prefetched
    (they would overflow the cap_r = 1024 packing). Runs of ~1060 and
    rescue_cutoff 1100 (tests/test_sharded_index.py:302): the port's
    8-shard run equals its host-lookup run and the JAX package's 8-shard
    run, with feed_miss 0 and rescue exercised."""
    from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
    from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline as JaxPipeline

    r = random.Random(77)
    unit, unit2 = random_dna(300, seed=78), random_dna(280, seed=79)
    genome = (random_dna(30000, seed=80) + unit * 1080 + random_dna(30000, seed=81)
              + unit2 * 60 + random_dna(30000, seed=82))
    jax_refs = JaxReferences()
    jax_refs.add("chrC", genome.encode())
    jax_index = JaxIndex(jax_refs, JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    runs = np.diff(np.flatnonzero(np.concatenate(
        ([True], jax_index.hashes[1:] != jax_index.hashes[:-1], [True]))))
    assert runs.max() > 1024, "need runs past the cap"
    refs = References()
    refs.add("chrC", genome.encode())
    index = _port_index(refs, jax_index)

    big = (30000, 30000 + 300 * 1080)
    mod = (big[1] + 30000, big[1] + 30000 + 280 * 60)
    lines = []
    for i in range(180):
        st = (r.randrange(*big) if i % 3 == 0 else r.randrange(*mod) if i % 3 == 1
              else r.randrange(0, len(genome) - 200))
        s = list(genome[st : st + 150])
        s[r.randrange(150)] = r.choice("ACGT")
        s = "".join(s)
        if i % 5 == 4:
            s = "".join(COMP[c] for c in reversed(s))
        lines.append((f"q{i}", s))
    fq = tmp_path / "bigrun.fq"
    fq.write_bytes(b"".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n".encode() for n, s in lines))

    mp = MappingParameters(r=150, rescue_cutoff=1100)  # e.g. -R 11 with filter_cutoff 100
    out = {}
    for name, sharded in (("host", None), ("shard", psh.ShardedIndex(psh.make_mesh(8, "cpu"),
                                                                      index))):
        pipe = pnp.NativePipeline(index, index.parameters, refs, AlignmentParameters(), mp,
                                  use_device=False, device="cpu", shard_index=sharded is not None,
                                  sharded_index=sharded)
        chunks = []
        pipe.map_file(str(fq), "", False, 60, chunks.append)
        out[name] = (b"".join(chunks), pipe.counters())
    jax_mp = JaxMapParams(r=150)
    jax_mp.rescue_cutoff = 1100
    jax_pipe = JaxPipeline(jax_index, jax_index.parameters, jax_refs, JaxAlnParams(), jax_mp,
                           use_device=False, shard_index=True,
                           sharded_index=jsh.ShardedIndex(_jax_mesh(8), jax_index))
    chunks = []
    jax_pipe.map_file(str(fq), "", False, 60, chunks.append)
    assert out["shard"][0] == out["host"][0] == b"".join(chunks)
    assert out["shard"][1]["feed_miss"] == 0
    assert out["shard"][1]["nam_rescue"] > 0


def test_shard_index_takes_precedence_over_device_seed(reads, monkeypatch):
    """`--shard-index --device-seed`: the sharded lookups serve phase A
    and the device seeding is never called; the SAM equals the default
    run's."""
    monkeypatch.setattr(pnp, "seed_and_find", lambda *a: pytest.fail("device seeding ran"))
    looked_up = []
    real = psh.ShardedIndex.find_runs_compact
    monkeypatch.setattr(psh.ShardedIndex, "find_runs_compact",
                        lambda self, *a: looked_up.append(1) or real(self, *a))
    argv = [str(reads / "ref.fa"), str(reads / "se.fq"), "-t", "1", "--chunk-size", "64",
            "--device", "cpu"]
    assert port_main(argv + ["-o", str(reads / "plain.sam")]) == 0
    assert port_main(argv + ["--shard-index", "--device-seed", "-o",
                             str(reads / "both.sam")]) == 0
    assert len(looked_up) >= 4  # every chunk of 260 reads
    assert _without_pg(reads / "both.sam") == _without_pg(reads / "plain.sam")


def test_make_mesh_on_the_cpu():
    import torch

    assert psh.make_mesh(device="cpu") == [torch.device("cpu")]
    assert psh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="every shard on one device"):
        psh.ShardedIndex([torch.device("cpu"), torch.device("meta")], _sentinel_stub())
