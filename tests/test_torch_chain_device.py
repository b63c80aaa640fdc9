"""The port's device NAM front end (ops/chain_device.py, ops/front_device.py)
on the CPU, through the plain versions its wrappers take for CPU tensors,
against rabbitsalign_tpu's on the JAX CPU backend, exact: the merge on the
synthetic streams of tests/test_chain_device.py (and a table of 4 that
overflows), on its boundary cases and at caps past 128, the batched `merge_streams` against one stream at a time,
`find_nams_device_chain`, `seed_find_walk` and `find_nams_composed_batch`
on that file's reads of its world. The index is the JAX package's,
carried over by `from_jax_arrays`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.index.params import IndexParameters as JaxParams
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.ops import chain_device as jcd
from rabbitsalign_tpu.ops import front_device as jfd
from rabbitsalign_tpu.seed.randstrobes import randstrobes_query as jax_query
from rabbitsalign_tpu_torch.chain.nams import find_nams
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.ops import chain_device as pcd
from rabbitsalign_tpu_torch.ops import front_device as pfd
from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

from .torch_chain_cases import (chain_reads, composed_reads, merge_edge_streams,
                                nam_key, stream_tensors, synthetic_streams, wide_streams,
                                world_genome)
from .torch_seed_cases import code_batch
from .util import random_dna

K = 20


@pytest.fixture(scope="module")
def world():
    genome = world_genome()
    jrefs, refs = JaxReferences(), References()
    for r in (jrefs, refs):
        r.add("cA", genome[:45000].encode())
        r.add("cB", genome[45000:].encode())
    jparams = JaxParams.from_read_length(150)
    jindex = JaxIndex(jrefs, jparams)
    jindex.populate(0.0002)
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex.from_jax_arrays(
        refs, params, jindex.hashes, jindex.positions, jindex.packed,
        jindex.randstrobe_start_indices, jindex.filter_cutoff, jindex.bits)
    return genome, jindex, jparams, index, params


@pytest.mark.parametrize("cap", [64, 32, 4])
def test_merge_hits_device_matches_jax(cap):
    """Rows and mask where the stream does not overflow, the overflow flag
    everywhere, on the 30 synthetic streams, each also with one row made
    invalid (a no-op step)."""
    n_ovf = n_rows = 0
    for case, (stream, seg) in enumerate(synthetic_streams()):
        hits, seg = np.asarray(stream, np.int32), np.asarray(seg, bool)
        for drop in (None, case % len(stream)):
            valid = np.ones(len(stream), bool)
            if drop is not None:
                valid[drop] = False
            want = [np.asarray(x) for x in jcd.merge_hits_device(hits, seg, valid, K, cap)]
            got = [x.numpy() for x in pcd.merge_hits_device(hits, seg, valid, K, cap)]
            assert bool(got[2]) == bool(want[2]), (case, drop)
            n_ovf += bool(want[2])
            if not want[2]:
                assert got[0].shape == want[0].shape and np.array_equal(got[1], want[1])
                assert np.array_equal(got[0][got[1]], want[0][want[1]])
                n_rows += int(want[1].sum())
    assert (n_ovf > 0) == (cap == 4) and n_rows > (20 if cap == 4 else 100)


def test_padded_merge_and_attribution_match_jax():
    """merge_stream_device_padded's rows, mask, H, Hp and overflow, and the
    groups iter_merged_nam_rows attributes each NAM to, equal the JAX
    functions' on the 30 synthetic streams."""
    n = 0
    for stream, seg in synthetic_streams():
        seg = np.asarray(seg, bool)
        got = pcd.merge_stream_device_padded(stream, seg, K, 64, device="cpu")
        want = jcd.merge_stream_device_padded(stream, seg, K, 64)
        assert got[2:] == want[2:] and not got[4]
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[0][got[1]],
                                                                  want[0][want[1]])
        rows = list(pcd.iter_merged_nam_rows(*got[:2], seg, *got[2:4]))
        assert rows == list(jcd.iter_merged_nam_rows(*want[:2], seg, *want[2:4]))
        n += len(rows)
    assert n > 100


@pytest.mark.parametrize("cap", [32, 4])
def test_merge_streams_matches_one_stream_at_a_time(cap):
    """One batched launch over the 30 streams equals each stream merged
    alone: emissions, counts and overflow flags."""
    streams = synthetic_streams()
    emis, counts, ovf = pcd.merge_streams(*stream_tensors(streams), K, cap)
    at = 0
    for j, stream in enumerate(streams):
        e, c, o = pcd.merge_streams(*stream_tensors([stream]), K, cap)
        assert torch.equal(emis[at:at + len(stream[0])], e)
        assert int(counts[j]) == int(c[0]) and bool(ovf[j]) == bool(o[0])
        at += len(stream[0])
    assert bool(ovf.any()) == (cap == 4) and int(counts.sum()) > (20 if cap == 4 else 100)


def _jax_emissions(stream, seg, cap):
    """One stream through the JAX merge (padded as its callers pad it, so
    that few shapes compile): its emissions as rows [step, slot, qs, qe,
    rs, re, n_hits], the end flush at step H, and its overflow flag (an
    empty stream, which the JAX function does not take, emits nothing)."""
    if not stream:
        return np.zeros((0, 7), np.int64), False
    rows, mask, H, Hp, ovf = jcd.merge_stream_device_padded(stream, np.asarray(seg, bool), K,
                                                            cap)
    rows, mask = np.asarray(rows), np.asarray(mask)
    at = np.argwhere(mask)
    steps = np.where(at[:, 0] == Hp, H, at[:, 0])
    return np.concatenate([steps[:, None], at[:, 1:2], rows[mask]], 1), bool(ovf)


def _streams_match_jax(streams, cap):
    """merge_streams over all `streams` in one call against the JAX merge
    of each alone: overflow flags everywhere; emissions, counts and zeros
    past them where the stream does not overflow (the JAX scan goes on
    past a full table). Returns (emissions checked, streams overflowing)."""
    emis, counts, ovf = pcd.merge_streams(*stream_tensors(streams), K, cap)
    at, n_rows, n_ovf = 0, 0, 0
    for j, (stream, seg) in enumerate(streams):
        want, want_ovf = _jax_emissions(stream, seg, cap)
        assert bool(ovf[j]) == want_ovf, j
        n_ovf += want_ovf
        if not want_ovf:
            got = emis[at:at + len(stream)].numpy()
            assert int(counts[j]) == len(want) and np.array_equal(got[:len(want)], want), j
            assert not got[len(want):].any(), j
            n_rows += len(want)
        at += len(stream)
    return n_rows, n_ovf


@pytest.mark.parametrize("cap", [200, 129, 32, 8, 3])
def test_merge_edge_cases_match_jax(cap):
    """The merge's boundary cases (tests/torch_chain_cases.py
    `merge_edge_streams`: lane tables of 8 and 32 slots full and one past
    them, sweeps and segment flushes on the lane's and the warp's
    paths, empty streams, more than 128 NAMs open at once) through
    `merge_streams` on the CPU equal the JAX merge, at caps past 128, the
    callers' 32, 8 and below."""
    n_rows, n_ovf = _streams_match_jax(merge_edge_streams(), cap)
    assert n_rows > (40 if cap > 3 else 0) and (n_ovf > 0) == (cap != 200)


@pytest.mark.parametrize("cap", [200, 129])
def test_merge_takes_caps_past_128(world, cap):
    """Every cap the JAX function takes: `merge_hits_device`,
    `merge_streams` and `find_nams_device_chain` at caps 200 and 129 equal
    the JAX package's on a stream of 201 hits, on streams that hold 150
    and 140 NAMs open at once (which overflow at 129) and on the world's
    reads."""
    genome, jindex, jparams, index, params = world
    crowded = [s for s in merge_edge_streams() if len(s[0]) >= 150]
    streams = wide_streams()[:1] + crowded
    for j, (stream, seg) in enumerate(streams):
        hits, seg = np.asarray(stream, np.int32), np.asarray(seg, bool)
        valid = np.ones(len(stream), bool)
        want = [np.asarray(x) for x in jcd.merge_hits_device(hits, seg, valid, K, cap)]
        got = [x.numpy() for x in pcd.merge_hits_device(hits, seg, valid, K, cap)]
        assert bool(got[2]) == bool(want[2]) == (cap == 129 and j > 0)
        if not want[2]:
            assert got[0].shape == want[0].shape and np.array_equal(got[1], want[1])
            assert np.array_equal(got[0][got[1]], want[0][want[1]])
    n_rows, n_ovf = _streams_match_jax(streams, cap)
    assert n_rows >= 199 and n_ovf == (2 if cap == 129 else 0)
    for read in chain_reads(genome)[:12]:
        got = pcd.find_nams_device_chain(randstrobes_query(read, params), index, cap=cap,
                                         device="cpu")
        want = jcd.find_nams_device_chain(jax_query(read, jparams), jindex, cap=cap)
        assert got[0] == want[0] and [nam_key(n) for n in got[1]] == [nam_key(n)
                                                                      for n in want[1]]


def test_find_nams_device_chain_matches_jax(world):
    """tests/test_chain_device.py:119's 50 reads: the fraction and every
    NAM field the merge carries, against the JAX function and the port's
    host find_nams."""
    genome, jindex, jparams, index, params = world
    n_nams = 0
    for read in chain_reads(genome):
        got = pcd.find_nams_device_chain(randstrobes_query(read, params), index, device="cpu")
        want = jcd.find_nams_device_chain(jax_query(read, jparams), jindex)
        host = find_nams(randstrobes_query(read, params), index)
        assert got[0] == want[0] == host[0]
        keys = [nam_key(n) for n in got[1]]
        assert keys == [nam_key(n) for n in want[1]] == [nam_key(n) for n in host[1]]
        n_nams += len(keys)
    assert n_nams > 100


def test_find_nams_device_chain_overflow_takes_the_host_path(world):
    """A table of 1 overflows on any read with two open NAMs: the read is
    chained by the host find_nams, with its prev-hit starts."""
    genome, _, _, index, params = world
    read = chain_reads(genome)[1]  # on the repeat array
    qrs = randstrobes_query(read, params)
    got = pcd.find_nams_device_chain(qrs, index, cap=1, device="cpu")
    host = find_nams(qrs, index)
    assert got[0] == host[0] and [repr(n) for n in got[1]] == [repr(n) for n in host[1]]
    assert any(n.query_prev_hit_startpos for n in got[1])  # only the host path sets them


def _upload(jindex, index):
    return jfd.upload_index_split(jindex), pfd.upload_index_split(index, "cpu")


def test_seed_find_walk_matches_jax(world):
    """tests/test_chain_device.py:143's 60 reads, plus reads on the unit
    repeat and tandem repeats of 3 to 25 bp units (duplicated window
    minima: tie rows): tie flags everywhere; on rows that are not ties, n_hits,
    total, good, overflow, and the hit rows (all maxh rows where the row
    does not overflow, the first maxh - 1 where it does: the JAX scatter
    writes every hit past maxh to its last row)."""
    genome, jindex, jparams, index, params = world
    seqs = composed_reads(genome) + [genome[30000 + 37 * i:30150 + 37 * i].encode()
                                     for i in range(8)]
    seqs += [(random_dna(u, seed=u) * 60)[:150].encode() for u in (3, 5, 8, 13, 25)]
    codes, lens = code_batch(seqs)
    jdev, pdev = _upload(jindex, index)
    sp, rp = params.syncmer, params.randstrobe
    common = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, 256)
    want = [np.asarray(x) for x in jfd.seed_find_walk(
        jnp.asarray(codes), jnp.asarray(lens), *jdev[:5], *common, jdev[5],
        jindex.filter_cutoff, 192, jindex.filter_cutoff, jdev[6])]
    for extra in ({}, {"idx_hashes": pdev[7]}):
        got = [x.numpy() for x in pfd.seed_find_walk(
            torch.from_numpy(codes), torch.from_numpy(lens), *pdev[:5], *common, pdev[5],
            index.filter_cutoff, 192, index.filter_cutoff, pdev[6], **extra)]
        tie, ovf = want[4], want[5]
        assert np.array_equal(got[4], tie)
        ok = ~tie
        for i in (1, 2, 3, 5):
            assert np.array_equal(got[i][ok], want[i][ok]), i
        assert np.array_equal(got[0][ok & ~ovf], want[0][ok & ~ovf])
        assert np.array_equal(got[0][ok & ovf, :-1], want[0][ok & ovf, :-1])
        assert not got[0][tie].any() and not got[1][tie].any()
    assert tie.any() and ovf[ok].any() and (~tie & ~ovf).sum() > 40


def test_find_nams_composed_batch_matches_jax(world):
    """The same 60 reads: the same None pattern (ties, hit and merge
    overflows take the host path) and, elsewhere, the same fraction and
    NAMs as the JAX function and the port's host find_nams; the four
    timed parts are reported."""
    genome, jindex, jparams, index, params = world
    seqs = composed_reads(genome) + [b"ACGT" * 80]  # longer than L: None
    jdev, pdev = _upload(jindex, index)
    want = jfd.find_nams_composed_batch(seqs, jdev, jparams, jindex.filter_cutoff)
    stats = {}
    got = pfd.find_nams_composed_batch(seqs, pdev, params, index.filter_cutoff, stats=stats)
    assert [g is None for g in got] == [w is None for w in want]
    checked = 0
    for sq, g, w in zip(seqs, got, want):
        if g is None:
            continue
        host = find_nams(randstrobes_query(sq, params), index)
        assert g[0] == w[0] == host[0]
        assert [nam_key(n) for n in g[1]] == [nam_key(n) for n in w[1]] \
            == [nam_key(n) for n in host[1]]
        checked += 1
    assert checked >= 45 and got[-1] is None
    assert {"front", "order", "merge", "attribute"} <= set(stats) and stats["long"] == 1
    assert stats["tie"] + stats["hit_overflow"] + stats["merge_overflow"] + 1 == sum(
        g is None for g in got)
