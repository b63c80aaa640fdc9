"""The sources of the device NAM front end's kernels, run on the CPU by
the thread-a-lane emulation of tests/torch_cuda_emu.h, against their
plain PyTorch versions: the exact syncmer scan (csrc/syncmers_scan.cu),
the sweep-line merge (csrc/merge_hits.cu) at one, two and four slot
groups a lane and with tables that overflow, and the run walk with its
keep rule (csrc/walk_hits.cu) on runs longer than a warp, with hits that
overflow. Everything is integer and made from a seed: every comparison is
exact."""

import numpy as np
import pytest
import torch

from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.ops import cuda_build, seed_device
from rabbitsalign_tpu_torch.ops.chain_device import merge_hits_plain
from rabbitsalign_tpu_torch.ops.front_device import walk_hits_plain

from . import torch_cuda_emu
from .torch_chain_cases import stream_tensors, synthetic_streams, wide_streams
from .torch_seed_cases import code_batch, edge_reads, sampled_reads
from .util import random_dna


@pytest.fixture(scope="module")
def chain_emu(tmp_path_factory):
    """The three sources built for the host, each its own library."""
    out = tmp_path_factory.mktemp("chain_emu")
    libs = {}
    for name, entry in (("syncmers_scan", "syncmers_scan_launch"),
                        ("merge_hits", "merge_hits_launch"), ("walk_hits", "walk_hits_launch")):
        libs[name] = torch_cuda_emu.build(name, out)
        cuda_build.declare(libs[name], (entry,))
    return libs


def _scan_reads():
    """Edge reads (empty, short, N runs, all-N, tandem repeats with
    duplicated window minima), sampled reads and more tandem repeats."""
    genome = random_dna(20000, seed=3).encode()
    rng = np.random.RandomState(4)
    repeats = [(random_dna(int(u), seed=int(u)) * 80)[:150].encode()
               for u in rng.randint(1, 30, 24)]
    return edge_reads(2) + sampled_reads(genome, 60, seed=5) + repeats


@pytest.mark.parametrize("M", [256, 12], ids=["M256", "M12"])
def test_syncmers_scan_source_on_host_matches_plain(chain_emu, M):
    """Positions, hashes and counts equal `syncmers_scan_plain`, for
    rows with tied minima, N runs, lengths 0 and past L (-1), and at
    M = 12 where rows have more syncmers than slots."""
    codes, lens = (torch.from_numpy(a) for a in code_batch(_scan_reads()))
    p = IndexParameters.from_read_length(150).syncmer
    want = seed_device.syncmers_scan_plain(codes, lens, p.k, p.s, p.t_syncmer, M)
    B = codes.shape[0]
    got = (torch.full((B, M), 7, dtype=torch.int32), torch.full((B, M), 7, dtype=torch.int64),
           torch.full((B,), 7, dtype=torch.int32))
    assert chain_emu["syncmers_scan"].syncmers_scan_launch(
        codes.data_ptr(), lens.data_ptr(), B, codes.shape[1], p.k, p.s, p.t_syncmer, M,
        *(x.data_ptr() for x in got), None) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[2].max()) == M if M == 12 else int(want[2].sum()) > 1000


def _emu_merge(lib, hits, seg, offsets, k, cap):
    S = offsets.numel() - 1
    out = torch.zeros((hits.shape[0], 7), dtype=torch.int32)
    counts = torch.full((S,), 7, dtype=torch.int32)
    ovf = torch.full((S,), 7, dtype=torch.uint8)
    assert lib.merge_hits_launch(hits.data_ptr(), seg.data_ptr(), offsets.data_ptr(), S, k, cap,
                                 out.data_ptr(), counts.data_ptr(), ovf.data_ptr(), None) == 0
    return out, counts, ovf.bool()


@pytest.mark.parametrize("which,cap", [("synthetic", 32), ("synthetic", 4), ("wide", 128),
                                       ("wide", 72)])
def test_merge_source_on_host_matches_plain(chain_emu, which, cap):
    """The emission rows, counts and overflow flags equal
    `merge_hits_plain`: the synthetic streams of test_chain_device.py at
    the callers' cap 32 and at 4 (overflowing), and streams holding over
    32 NAMs open (two and four slot groups a lane) at caps that hold
    them and that overflow."""
    streams = synthetic_streams() if which == "synthetic" else wide_streams()
    args = stream_tensors(streams)
    want = merge_hits_plain(*args, 20, cap)
    got = _emu_merge(chain_emu["merge_hits"], *args, 20, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[2].any()) == (cap in (4, 72))
    assert int(want[1].sum()) > len(streams)
    if which == "wide":  # a flush of more than 64 open NAMs: all four slot groups
        assert int(want[0][:, 0].bincount().max()) > 64 or cap < 128


@pytest.fixture(scope="module")
def long_runs_world():
    """An index whose repeat array gives runs of about 80 rows (longer
    than a warp's round of 32), and reads on it and off it."""
    unit = random_dna(300, seed=21)
    genome = random_dna(20000, seed=22) + unit * 80 + random_dna(20000, seed=23)
    refs = References()
    refs.add("c", genome.encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    reads = sampled_reads(genome.encode(), 40, seed=24)
    return index, params, reads


def _strobes(index, params, reads):
    """The reads' strobes in the seeding buffer's layout, looked up."""
    codes, lens = (torch.from_numpy(a) for a in code_batch(reads))
    sp, rp = params.syncmer, params.randstrobe
    buf, total = seed_device.seed_strobes_plain(codes, lens, sp.k, sp.s, sp.t_syncmer, rp.w_min,
                                                rp.w_max, rp.q, rp.max_dist, 256)
    views = seed_device.strobe_views(buf, len(reads), total)
    h, b = (torch.from_numpy(a.view(np.int64)) for a in (index.hashes,
                                                         index.randstrobe_start_indices))
    views[6].copy_(seed_device.index_find_device(h, b, index.bits, views[2]))
    planes = (h, torch.from_numpy(index.positions.view(np.int32)),
              torch.from_numpy(index.packed.view(np.int32)))
    return views, planes


@pytest.mark.parametrize("cutoff,maxh,cap", [(None, 192, None), (1000, 4000, 100),
                                             (1000, 40, 70), (3, 192, 3)],
                         ids=["filter-cutoff", "all-kept", "hit-overflow", "filtered"])
def test_walk_source_on_host_matches_plain(chain_emu, long_runs_world, cutoff, maxh, cap):
    """Hits, n_hits, total, good and overflow equal `walk_hits_plain`:
    at the index's filter cutoff (80, the repeat's runs of 80 rows walked
    over three rounds of 32, the repeat's reads past maxh); with maxh
    large enough for every kept hit; with maxh 40; and with a cutoff of 3
    that filters the repeat's strobes."""
    index, params, reads = long_runs_world
    views, planes = _strobes(index, params, reads)
    cutoff = index.filter_cutoff if cutoff is None else cutoff
    cap = cutoff if cap is None else cap
    k = params.syncmer.k
    want = walk_hits_plain(*views[:7], *planes, k, cutoff, maxh, cap)
    N = len(reads)
    got = [torch.zeros((N, maxh, 6), dtype=torch.int32)] + [
        torch.full((N,), 7, dtype=torch.int32) for _ in range(3)] + [
        torch.full((N,), 7, dtype=torch.uint8)]
    assert chain_emu["walk_hits"].walk_hits_launch(
        *(x.data_ptr() for x in views[:6]), views[6].data_ptr(), N,
        *(x.data_ptr() for x in planes), planes[0].numel(), k, cutoff, maxh, cap,
        *(x.data_ptr() for x in got), None) == 0
    got[4] = got[4].bool()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].sum()) > N
    assert bool(want[4].any()) == (maxh < 4000 and cutoff != 3)
    assert bool((want[2] > want[3]).any()) == (cutoff == 3)
    assert index.filter_cutoff == 80
