"""The port's host NAM modules against rabbitsalign_tpu's, exact: find_nams
and find_nams_rescue (chain/nams.py) on the reads of
tests/test_chain_device.py's world, introsort (utils/sorting.py) and
robinhood_order (native) on seeded keys with ties, the index's query
methods, and the port's find_nams_chunk (the engine) against its own
find_nams. The index is the JAX package's, carried over by
`from_jax_arrays`, so both packages query identical state."""

import numpy as np
import pytest

from rabbitsalign_tpu import native as jnative
from rabbitsalign_tpu.chain import nams as jnams
from rabbitsalign_tpu.index.params import IndexParameters as JaxParams
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.seed.randstrobes import randstrobes_query as jax_query
from rabbitsalign_tpu.utils.sorting import introsort as jax_introsort
from rabbitsalign_tpu_torch import native
from rabbitsalign_tpu_torch.chain import nams
from rabbitsalign_tpu_torch.chain.native_nams import find_nams_chunk
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query
from rabbitsalign_tpu_torch.utils.sorting import introsort

from .torch_chain_cases import chain_reads, composed_reads, nam_key, world_genome


def full_key(n):
    """Every field of a host NAM, the prev-hit starts included."""
    return (n.nam_id, n.query_start, n.query_end, n.query_prev_hit_startpos, n.ref_start,
            n.ref_end, n.ref_prev_hit_startpos, n.n_hits, n.ref_id, n.score, n.is_rc)


@pytest.fixture(scope="module")
def world():
    """tests/test_chain_device.py:24-35's world in both packages: the
    JAX index and the port's over its arrays."""
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
    reads = chain_reads(genome) + composed_reads(genome)
    return genome, jindex, jparams, index, params, reads


def test_find_nams_matches_jax(world):
    """The nonrepetitive fraction and every field of every NAM, on the
    110 reads (repeat-array, shared-segment and reverse-complement reads
    among them: several contigs' groups, the repetitive filter)."""
    _, jindex, jparams, index, params, reads = world
    n_nams = multi = 0
    for read in reads:
        got = nams.find_nams(randstrobes_query(read, params), index)
        want = jnams.find_nams(jax_query(read, jparams), jindex)
        assert got[0] == want[0]
        assert [full_key(n) for n in got[1]] == [full_key(n) for n in want[1]], read[:30]
        n_nams += len(got[1])
        multi += len({n.ref_id for n in got[1]}) > 1
    assert n_nams > 300 and multi > 10


@pytest.mark.parametrize("rescue_cutoff", [2, 100])
def test_find_nams_rescue_matches_jax(world, rescue_cutoff):
    _, jindex, jparams, index, params, reads = world
    total = 0
    for read in reads:
        got = nams.find_nams_rescue(randstrobes_query(read, params), index, rescue_cutoff)
        want = jnams.find_nams_rescue(jax_query(read, jparams), jindex, rescue_cutoff)
        assert [full_key(n) for n in got] == [full_key(n) for n in want], read[:30]
        total += len(got)
    assert total > 300


def test_introsort_and_robinhood_order_match_jax():
    """Ascending u64 keys and descending float64 keys with many ties (the
    order of equal keys is std::sort's, not stable), at lengths past
    introsort's insertion-sort cutoff of 16; and robin_hood iteration
    orders of 2 to 300 ref ids (the map's growth included)."""
    rng = np.random.RandomState(12)
    for n in (2, 5, 16, 17, 40, 300, 2000):
        keys = rng.randint(0, 6, n).astype(np.uint64) << np.uint64(32)
        lst, jlst = list(range(n)), list(range(n))
        introsort(lst, keys.tolist(), False)
        jax_introsort(jlst, keys.tolist(), False)
        assert lst == jlst
        scores = rng.randint(0, 4, n).astype(np.float64) * 1.5
        lst, jlst = list(range(n)), list(range(n))
        introsort(lst, scores.tolist(), True)
        jax_introsort(jlst, scores.tolist(), True)
        assert lst == jlst
    assert lst != sorted(range(n), key=lambda i: -scores[i])  # not the stable order
    for n in (2, 3, 9, 60, 300):
        ids = rng.choice(1 << 20, n, replace=False).astype(np.uint32)
        got = native.robinhood_order(ids)
        assert np.array_equal(got, jnative.robinhood_order(ids))
        assert sorted(got.tolist()) == list(range(n))


def test_index_queries_match_jax(world):
    """find, get_count, is_filtered, get_hash (past the end too) and the
    record accessors, on every hash, the smallest one (the bucket table's
    quirk), its neighbours and misses."""
    _, jindex, _, index, _, _ = world
    rng = np.random.RandomState(3)
    h = index.hashes
    keys = np.concatenate([h, h[:500] + np.uint64(1), h[:1],
                           rng.randint(0, 2**63, 300).astype(np.uint64)])
    pos = index.find(keys)
    assert np.array_equal(pos, jindex.find(keys))
    assert index.find(h[:1][0]) == -1 and (pos[:h.size] >= 0).mean() > 0.99
    found = pos[pos >= 0]
    assert np.array_equal(index.get_count(found), jindex.get_count(found))
    every = np.arange(h.size)
    cutoff = index.filter_cutoff
    try:
        for c in (cutoff, 3):  # 3: the repeat's runs are filtered
            index.filter_cutoff = jindex.filter_cutoff = c
            filtered = index.is_filtered(every)
            assert np.array_equal(filtered, jindex.is_filtered(every))
    finally:
        index.filter_cutoff = jindex.filter_cutoff = cutoff
    assert filtered.any() and not filtered.all()
    at = np.array([0, 5, h.size - 1, h.size, h.size + 7])
    assert np.array_equal(index.get_hash(at), jindex.get_hash(at))
    for name in ("reference_index", "strobe2_offset", "get_strobe1_position"):
        assert np.array_equal(getattr(index, name)(found), getattr(jindex, name)(found))
    assert (index.k(), index.size()) == (jindex.k(), jindex.size())


@pytest.mark.parametrize("rescue_level", [0, 2])
def test_find_nams_chunk_matches_find_nams(world, rescue_level):
    """The engine's chunk call against the port's Python find_nams (and
    find_nams_rescue at level 2, where a read without NAMs or below 0.7
    nonrepetitive takes the rescue): every field, the score and the
    fraction as the engine's float32."""
    _, _, _, index, params, reads = world
    rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    got, nonrep, used = find_nams_chunk(reads, index, params, rescue_cutoff, rescue_level)
    n_rescued = 0
    for i, read in enumerate(reads):
        qrs = randstrobes_query(read, params)
        frac, want = nams.find_nams(qrs, index)
        rescue = rescue_level > 1 and (not want or frac < 0.7)
        if rescue:
            want = nams.find_nams_rescue(qrs, index, rescue_cutoff)
        else:
            assert nonrep[i] == np.float32(frac)
        n_rescued += rescue
        assert bool(used[i]) == rescue
        assert ([full_key(n)[:-2] + (np.float32(n.score), n.is_rc) for n in got[i]]
                == [full_key(n)[:-2] + (np.float32(n.score), n.is_rc) for n in want]), i
        assert [nam_key(n, np.float32) for n in got[i]] == [nam_key(n, np.float32) for n in want]
    assert n_rescued > 0 if rescue_level > 1 else not used.any()
