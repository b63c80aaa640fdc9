"""The port's seeding (`--device-seed`) against rabbitsalign_tpu's, with
tolerance 0: the host seed modules array for array, and the plain
PyTorch versions of ops/seed_device.py (which the CUDA wrappers take on
CPU tensors) against the JAX functions on the CPU, at the shapes of
tests/test_seed_device.py. Last, the compacted arrays that each
package's `_preseed` hands to the engine's `chunk_a_fx_pre`."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.ops import seed_device as jsd
from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline as JaxPipeline
from rabbitsalign_tpu.seed import hash as jhash
from rabbitsalign_tpu.seed import randstrobes as jrs
from rabbitsalign_tpu.seed import syncmers as jsy
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.ops import seed_cuda
from rabbitsalign_tpu_torch.ops import seed_device as psd
from rabbitsalign_tpu_torch.pipeline.native_pipeline import (SPAN_TIMERS, DeviceRun,
                                                             NativePipeline)
from rabbitsalign_tpu_torch.seed import hash as phash
from rabbitsalign_tpu_torch.seed import randstrobes as prs
from rabbitsalign_tpu_torch.seed import syncmers as psy

from . import torch_cuda_emu
from .torch_seed_cases import code_batch, edge_reads, sampled_reads
from .torch_seed_lanes import seed_lanes
from .util import random_dna

MP = {"A": 0, "C": 1, "G": 2, "T": 3}


def _sequence(kind: str) -> str:
    r = random.Random(kind)
    if kind == "random":
        return random_dna(3000, seed=11)
    if kind == "repeat":  # tandem units: duplicated window minima
        return "".join(random_dna(n, seed=n) * reps for n, reps in ((3, 60), (8, 40), (25, 30)))
    # N runs, and lower case, inside random sequence
    seq = list(random_dna(2400, seed=12))
    for _ in range(12):
        p, n = r.randrange(len(seq) - 40), r.randrange(1, 30)
        seq[p:p + n] = ["N"] * n
    seq = "".join(seq)
    return seq[:600].lower() + seq[600:]


@pytest.mark.parametrize("kind", ["random", "repeat", "n-runs"])
def test_seed_modules_match_jax(kind):
    seq = _sequence(kind)
    p = IndexParameters.from_read_length(150)
    jp = JaxIndexParameters.from_read_length(150)
    sp = p.syncmer
    for fn in ("syncmers", "syncmers_slow"):
        got = getattr(psy, fn)(seq, sp.k, sp.s, sp.t_syncmer)
        want = getattr(jsy, fn)(seq, sp.k, sp.s, sp.t_syncmer)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want)), fn
    pos, h = psy.syncmers(seq, sp.k, sp.s, sp.t_syncmer)
    assert pos.size > 10
    assert np.array_equal(*(m.syncmers_slow(seq, sp.k, sp.s, sp.t_syncmer)[0] for m in (psy, jsy)))
    rp = p.randstrobe
    for g, w in zip(prs.link_randstrobes(pos, h, rp.w_min, rp.w_max, rp.q, rp.max_dist),
                    jrs.link_randstrobes(pos, h, rp.w_min, rp.w_max, rp.q, rp.max_dist)):
        assert np.array_equal(g, w)
    for g, w in zip(prs.randstrobes_reference(seq, p), jrs.randstrobes_reference(seq, jp)):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    for read in (seq[:150], seq[1000:1150], seq[:11], seq[:256]):
        g, w = prs.randstrobes_query(read, p), jrs.randstrobes_query(read, jp)
        for a, b in ((getattr(g, f), getattr(w, f)) for f in ("hash", "start", "end", "is_reverse")):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(phash.xxh64(h), jhash.xxh64(h))
    assert np.array_equal(phash.popcount64(h), jhash.popcount64(h))


def test_xxh64_u64_wraps_like_numpy_and_jax():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 1 << 62, size=4096, dtype=np.uint64) * np.uint64(4) + np.uint64(3)
    x[:6] = [0, 1, (1 << 64) - 1, 1 << 63, (1 << 63) - 1, 0x9E3779B185EBCA87]
    got = psd.xxh64_u64(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, jhash.xxh64(x))
    assert np.array_equal(got, np.asarray(jsd.xxh64_u64(jnp.asarray(x))))
    # the products overflow int64, so the test holds only if they wrap
    assert (got > np.uint64(1 << 63)).any() and (got < np.uint64(1 << 63)).any()
    pc = psd.popcount64(torch.from_numpy(x.view(np.int64))).numpy()
    assert np.array_equal(pc, jhash.popcount64(x).astype(np.int64))
    a, b = (torch.from_numpy(v.view(np.int64)) for v in (x[:2048], x[2048:]))
    assert np.array_equal(psd.umin(a, b).numpy().view(np.uint64), np.minimum(x[:2048], x[2048:]))


def _mix_reads():
    """tests/test_seed_device.py:test_randstrobes_query_vec_matches_host's
    120 reads (incl. < w_max, tandem repeats and an N)."""
    r = random.Random(7)
    reads = []
    for i in range(120):
        L = r.choice([150, 150, 150, 100, 40, 11])
        if i % 4 == 0:
            unit = "".join(r.choice("ACGT") for _ in range(r.choice([3, 8, 25])))
            sq = (unit * (L // len(unit) + 1))[:L]
        else:
            sq = "".join(r.choice("ACGT") for _ in range(L))
        if i % 9 == 2 and L > 20:
            sq = sq[:10] + "N" + sq[11:]
        reads.append(sq)
    return reads, IndexParameters.from_read_length(150)


def _wide_reads():
    """:test_randstrobes_query_vec_wide_window's 96 reads, window 20."""
    p = IndexParameters.from_read_length(150, l=0, u=19, max_seed_len=255)
    r = random.Random(23)
    reads = []
    for i in range(96):
        if i % 2 == 0:
            unit = "".join(r.choice("ACGT") for _ in range(r.choice([100, 110, 120, 130])))
            reads.append((unit * 2)[:150])
        else:
            reads.append("".join(r.choice("ACGT") for _ in range(150)))
    return reads, p


def _codes(reads, L=None):
    L = L or max(len(x) for x in reads)
    codes = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, sq in enumerate(reads):
        codes[i, :len(sq)] = [MP.get(c, 4) for c in sq]
        lens[i] = len(sq)
    return codes, lens


@pytest.mark.parametrize("case", ["mix", "wide-window"])
def test_randstrobes_query_vec_matches_jax(case):
    reads, p = _mix_reads() if case == "mix" else _wide_reads()
    sp, rp = p.syncmer, p.randstrobe
    M = 64
    codes, lens = _codes(reads)
    args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, M)
    jh, js, je, jnf, jnr, jtie = (np.asarray(x) for x in jsd.randstrobes_query_vec(
        jnp.asarray(codes), jnp.asarray(lens), *args))
    plain = psd.randstrobes_query_vec(torch.from_numpy(codes), torch.from_numpy(lens), *args)
    ph, ps, pe, pnf, pnr, ptie = (x.numpy() for x in plain)
    assert np.array_equal(pnf, jnf) and np.array_equal(pnr, jnr) and np.array_equal(ptie, jtie)
    assert ph.dtype == np.int64 and ps.dtype == pe.dtype == pnf.dtype == np.int32
    slot = np.arange(2 * M)[None, :]
    valid = np.where(slot < M, slot < jnf[:, None], slot - M < jnr[:, None])
    assert np.array_equal(ph.view(np.uint64)[valid], jh[valid])
    assert np.array_equal(ps[valid], js[valid]) and np.array_equal(pe[valid], je[valid])
    assert (ph[~valid] == 0).all() and (ps[~valid] == -1).all() and (pe[~valid] == -1).all()
    assert ptie.sum() < len(reads) // 2 and valid.sum() > 20 * len(reads)
    assert ptie.sum() > 0 or case == "wide-window"  # the mix's tandem repeats tie
    # the seeding kernel's wrapper takes its plain version on the CPU: the
    # JAX valid slots compacted, forward then reverse a read, tie rows out
    buf, total = seed_cuda.seed_randstrobes(torch.from_numpy(codes), torch.from_numpy(lens), *args)
    counts, offsets, hashes, starts, ends, is_rev, _ = (
        x.numpy() for x in psd.strobe_views(buf, len(reads), total))
    keep = valid & ~jtie[:, None]
    want_counts = np.where(jtie, -1, jnf + jnr)
    assert counts.dtype == np.int32 and np.array_equal(counts, want_counts)
    assert offsets.dtype == np.int64
    assert np.array_equal(offsets, np.cumsum(np.maximum(want_counts, 0)) - np.maximum(want_counts, 0))
    assert total == keep.sum() == int(buf[:8].view(torch.int64)[0])
    assert np.array_equal(hashes.view(np.uint64), jh[keep])
    assert np.array_equal(starts, js[keep]) and np.array_equal(ends, je[keep])
    assert np.array_equal(is_rev, np.broadcast_to(slot >= M, keep.shape)[keep].astype(np.uint8))
    assert buf.numel() == psd.strobe_bytes(len(reads), total)
    # non-tie rows are the host's randstrobes
    for i in np.flatnonzero(~ptie):
        g = prs.randstrobes_query(reads[i], p)
        assert list(ph[i][valid[i]].view(np.uint64)) == list(g.hash)
        assert list(ps[i][valid[i]]) == list(g.start) and list(pe[i][valid[i]]) == list(g.end)


def _window_profile(window: str) -> IndexParameters:
    """The 150 profile, a wide window (w 20) at 150, or the 250 profile
    (w_min 8, w_max 17, max_dist 180)."""
    if window == "wide":
        return IndexParameters.from_read_length(150, l=0, u=19, max_seed_len=255)
    return IndexParameters.from_read_length(250 if window == "r250" else 150)


def _read_len(window: str) -> int:
    return 250 if window == "r250" else 150


# M under a read's syncmers makes tie rows; at the 250 profile a row needs
# over w_min = 8 syncmers for a strobe, so its small M is 24, not 12
WINDOWS_M = [("r150", 256), ("r150", 12), ("wide", 256), ("wide", 12), ("r250", 256),
             ("r250", 24)]


@pytest.mark.parametrize("window,M", WINDOWS_M)
def test_seed_lane_replay_matches_plain(window, M):
    """The lane-by-lane replay of csrc/seed_randstrobes.cu (tests/
    torch_seed_lanes.py: lane runs, rolled values, the warp scan, the
    tiles' scan and offsets, the linking lanes) writes the bytes of
    `seed_strobes_plain` on the edge reads (lengths 0 to 300, N's, tie
    rows) and reads of a genome; with M = 12 < L - k + 1 the rows with
    more than M syncmers are tie rows too (M = 24 at the 250 profile)."""
    p = _window_profile(window)
    sp, rp = p.syncmer, p.randstrobe
    args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, M)
    genome = random_dna(20000, seed=5).encode()
    reads = (edge_reads(2) + sampled_reads(genome, 40, seed=3, length=_read_len(window))
             + [genome[:50], genome[:256]])
    codes, lens = code_batch(reads)
    got, total, lanes = seed_lanes(codes, lens, *args)
    want, want_total = psd.seed_strobes_plain(torch.from_numpy(codes), torch.from_numpy(lens),
                                              *args)
    assert total == want_total > 0
    assert np.array_equal(got, want.numpy())
    counts = psd.strobe_views(want, len(reads), total)[0].numpy()
    assert (counts == -1).sum() >= 3 and (counts > 0).any()
    if M < 256:  # over M syncmers: tie rows
        assert (counts[len(edge_reads(2)):] == -1).sum() > 30
    else:
        assert (counts > 0).sum() >= 30
    ran = [ln for ln in lanes if ln is not None]
    assert max(ln["per"] for ln in ran) == 8 and min(ln["per"] for ln in ran) == 1
    assert max((ln["lane_counts"] > 0).sum() for ln in ran) > 16  # syncmers on many lanes


@pytest.fixture(scope="module")
def seed_emu(tmp_path_factory):
    """csrc/seed_randstrobes.cu built for the host (tests/torch_cuda_emu.py)."""
    from rabbitsalign_tpu_torch.ops import cuda_build

    lib = torch_cuda_emu.build("seed_randstrobes", tmp_path_factory.mktemp("seed_emu"))
    cuda_build.declare(lib, ("seed_randstrobes_launch",))
    return lib


@pytest.mark.parametrize("window,M", WINDOWS_M)
def test_seed_kernel_source_on_host_matches_plain(seed_emu, window, M):
    """The seeding kernel's own source, run on the host by the thread-a-lane
    emulation, writes the bytes of `seed_strobes_plain` through the
    wrapper's buffer layout (counts, offsets, total and strobes), and
    nothing between the strobes and its scratch."""
    import ctypes

    p = _window_profile(window)
    sp, rp = p.syncmer, p.randstrobe
    args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, M)
    genome = random_dna(20000, seed=6).encode()
    reads = (edge_reads(5) + sampled_reads(genome, 60, seed=4, length=_read_len(window))
             + [genome[:40], genome[:70]])
    codes, lens = (torch.from_numpy(a) for a in code_batch(reads))
    N, L = codes.shape
    want, total = psd.seed_strobes_plain(codes, lens, *args)
    buf = seed_cuda.seed_buffer(N, M, "cpu").fill_(0xA5)
    at, scratch = psd.strobes_at(N), seed_cuda._scratch_at(N, M)
    ptr = buf.data_ptr()
    assert seed_emu.seed_randstrobes_launch(
        codes.data_ptr(), lens.data_ptr(), N, L, *args[:5], ctypes.c_uint64(args[5]), args[6], M,
        ptr + 8, ptr + at - 8 * N, ptr, ptr + at, ptr + scratch + 8 * N * M, ptr + scratch,
        ptr + seed_cuda._tiles_at(N, M), None) == 0
    assert int(buf[:8].view(torch.int64)[0]) == total
    for g, w in zip(psd.strobe_views(buf, N, total)[:6], psd.strobe_views(want, N, total)[:6]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool((buf[psd.strobe_bytes(N, total):scratch] == 0xA5).all())
    counts = psd.strobe_views(buf, N, total)[0]
    assert (counts == -1).any() and (counts > 0).any()


def _jax_index(genome: str, bits: int = -1):
    refs = JaxReferences()
    refs.add("c", genome.encode())
    index = JaxIndex(refs, JaxIndexParameters.from_read_length(150), bits)
    index.populate(0.0002)
    return index


def _find_both(index_hashes, buckets, bits, keys):
    want = np.asarray(jsd.index_find_device(jnp.asarray(index_hashes), jnp.asarray(buckets),
                                            jnp.uint64(bits), jnp.asarray(keys)))
    args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int64))
            for a in (index_hashes, buckets, keys)]
    got = psd.index_find_device(args[0], args[1], bits, args[2]).numpy()
    assert torch.equal(seed_cuda.index_find(args[0], args[1], bits, args[2]), torch.from_numpy(got))
    return got, want


def test_index_find_matches_jax():
    """Hits, misses, empty buckets, long repeat runs and the run of the
    smallest hash (the bucket table's quirk: -1), as a (B, S) batch."""
    r = random.Random(3)
    genome = random_dna(30000, seed=7) + random_dna(200, seed=77) * 60 + random_dna(10000, seed=9)
    index = _jax_index(genome)
    n = len(index)
    keys = [int(index.hashes[r.randrange(n)]) for _ in range(500)]
    keys += [int(index.hashes[0]), int(index.hashes[-1])]
    keys += [r.getrandbits(64) for _ in range(202)]
    keys = np.array(keys, dtype=np.uint64).reshape(44, 16)
    got, want = _find_both(index.hashes, index.randstrobe_start_indices, index.bits, keys)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(index.find(keys.ravel())).reshape(keys.shape))
    assert got[31, 4] == -1 and (got >= 0).sum() >= 450


def test_index_find_all_equal_index_finds_nothing():
    """An index whose hashes are all equal: every bucket at n."""
    index = _jax_index(random_dna(5000, seed=2), bits=8)
    index.hashes = np.full(7, index.hashes[100], np.uint64)
    index._build_buckets()
    keys = np.array([index.hashes[0], 0, (1 << 64) - 1, int(index.hashes[0]) + 1], np.uint64)
    got, want = _find_both(index.hashes, index.randstrobe_start_indices, index.bits, keys)
    assert np.array_equal(got, want) and (got == -1).all()


class _StubEngine:
    """fx_codes hands out a fixed code batch; chunk_a_fx_pre records what
    it was given."""

    def __init__(self, codes, lens):
        self.codes, self.lens = codes, lens

    def fx_codes(self, fx, n_records, L):
        assert (n_records, L) == self.codes.shape
        return self.codes.copy(), self.lens.copy()

    def chunk_a_fx_pre(self, fx, chunk_index, *arrays, walk=None):
        self.arrays = [np.array(a) for a in arrays]
        self.walk = walk
        return "chunk"


def test_preseed_arrays_match_jax():
    """Both `_preseed`s on one chunk: the counts (-1 for tie and long
    reads), offsets and the compacted strobes with their index hits that
    reach `chunk_a_fx_pre` are the same bytes."""
    genome = random_dna(60000, seed=21)
    index = _jax_index(genome)
    r = random.Random(4)
    reads = []
    for i in range(300):
        ln = r.choice([150, 150, 150, 100, 40, 11, 256, 300])
        st = r.randrange(len(genome) - ln)
        sq = genome[st:st + ln]
        if i % 7 == 0:
            unit = random_dna(r.choice([3, 8]), seed=i)
            sq = (unit * ln)[:ln]
        if i % 11 == 3:
            sq = sq[:20] + "NNNN" + sq[24:]
        reads.append(sq)
    codes, lens = _codes([sq if len(sq) <= 256 else "" for sq in reads], L=256)
    lens[[i for i, sq in enumerate(reads) if len(sq) > 256]] = -1

    jax_pipe = object.__new__(JaxPipeline)
    jax_pipe.engine = _StubEngine(codes, lens)
    jax_pipe._seed_ix, jax_pipe._index, jax_pipe._params = None, index, index.parameters
    jax_pipe._devices = jax.devices()
    port = object.__new__(NativePipeline)
    port.engine = _StubEngine(codes, lens)
    port._index, port._params = index, IndexParameters.from_read_length(150)
    # the seed index goes up in set-up
    port.run = DeviceRun(index, AlignmentParameters(), device="cpu", device_seed=True)
    port.device = port.run.device
    port.span_s = dict.fromkeys(SPAN_TIMERS, 0.0)
    chunk, host_seeded, host_walked = port._preseed(None, len(reads), 0)
    assert jax_pipe._preseed(None, len(reads), 0) == chunk == "chunk"

    want, got = jax_pipe.engine.arrays, port.engine.arrays
    counts, offsets = got[:2]
    total = int((np.maximum(counts, 0)).sum())
    assert np.array_equal(counts, want[0]) and counts.dtype == np.int32
    assert np.array_equal(offsets, want[1]) and offsets.dtype == np.int64
    for g, w in zip(got[2:], want[2:]):  # hashes, starts, ends, is_rev, positions
        assert g.dtype == w.dtype and g.size == max(total, 1)
        assert np.array_equal(g[:total], w[:total])
    assert host_seeded == int((counts < 0).sum()) >= 40  # ties and reads over 256
    assert port.span_s["device_seed_s"] > 0
    assert (got[6][:total] >= 0).sum() > total // 2  # most strobes hit the index
    # the port's run walk went to the engine beside them
    assert jax_pipe.engine.walk is None and len(port.engine.walk) == 5
    assert host_walked == host_seeded + int(port.engine.walk[4].sum())
