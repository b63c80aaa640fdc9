"""The port's exact scan seeder and split lookups (ops/seed_device.py) on
the CPU, through the plain versions, against rabbitsalign_tpu's on the JAX
CPU backend, exact on every output slot: `syncmers_device`,
`link_randstrobes_device`, `randstrobes_query_device` (on tandem repeats
too, whose tie rows the vectorised seeder flags and this one decides),
`split_hash_u64`, `index_find_device_split`, `index_find_device_gary` and
`gary_iters`, at the shapes of tests/test_seed_device.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.index.params import IndexParameters as JaxParams
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.ops import seed_device as jsd
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.ops import seed_device as psd
from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

from .torch_seed_cases import code_batch, edge_reads
from .util import random_dna


def _reads():
    """tests/test_seed_device.py's read mix (random, N runs, lengths 10
    to 150) with tandem repeats of 3 to 25 bp units and the edge reads."""
    rng = random.Random(77)
    reads = []
    for i in range(64):
        ln = rng.choice([150, 150, 150, 100, 75, 40, 10])
        rd = "".join(rng.choice("ACGT") for _ in range(ln))
        if i % 4 == 1 and ln > 40:
            p = rng.randrange(10, ln - 10)
            rd = rd[:p] + "N" * rng.randrange(1, 6) + rd[p + 1:]
        reads.append(rd.encode()[:ln])
    for i in range(40):
        unit = "".join(rng.choice("ACGT") for _ in range(rng.choice([3, 8, 25])))
        reads.append((unit * 60)[:rng.choice([150, 100])].encode())
    return reads + [r for r in edge_reads(1) if len(r) <= 256]


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("M", [256, 40], ids=["M256", "M40"])
def test_syncmers_device_matches_jax(M):
    codes, lens = code_batch(_reads())
    p = IndexParameters.from_read_length(150).syncmer
    pos, h, counts = psd.syncmers_device(torch.from_numpy(codes), torch.from_numpy(lens), p.k,
                                         p.s, p.t_syncmer, M)
    want = [np.asarray(x) for x in jsd.syncmers_device(codes, lens, p.k, p.s, p.t_syncmer, M)]
    assert np.array_equal(counts.numpy(), want[2])
    if M == 256:  # with M past the count; the JAX scatter is undefined at a full row
        assert np.array_equal(pos.numpy(), want[0]) and np.array_equal(_u64(h), want[1])
    else:
        ok = counts.numpy() < M
        assert np.array_equal(pos.numpy()[ok], want[0][ok])
        assert np.array_equal(_u64(h)[ok], want[1][ok])
        assert (~ok).any()
    assert int(counts.sum()) > 2000


def test_link_and_randstrobes_query_device_match_jax():
    """Every slot of both functions' outputs, the JAX arithmetic past the
    valid slots included; and on every row, tie rows among them, the host
    randstrobes_query's strobes."""
    reads = [r for r in _reads() if len(r) <= 150]
    codes, lens = code_batch(reads, 150)
    params = IndexParameters.from_read_length(150)
    sp, rp = params.syncmer, params.randstrobe
    syn = jsd.syncmers_device(codes, lens, sp.k, sp.s, sp.t_syncmer, 150)
    want = [np.asarray(x) for x in jsd.link_randstrobes_device(
        *syn, rp.w_min, rp.w_max, rp.q, rp.max_dist, sp.k)]
    got = psd.link_randstrobes_device(
        *(torch.from_numpy(np.array(x)) for x in (syn[0], np.asarray(syn[1]).view(np.int64),
                                                  syn[2])), rp.w_min, rp.w_max, rp.q,
        rp.max_dist, sp.k)
    assert np.array_equal(_u64(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w)

    args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, 150)
    want = [np.asarray(x) for x in jsd.randstrobes_query_device(codes, lens, *args)]
    got = psd.randstrobes_query_device(torch.from_numpy(codes), torch.from_numpy(lens), *args)
    assert np.array_equal(_u64(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w)
    tie = psd.randstrobes_query_vec(torch.from_numpy(codes), torch.from_numpy(lens),
                                    *args[:-1], 150)[5].numpy()
    h, st, en, _, nf, nr = (x.numpy() for x in got)
    for i, read in enumerate(reads):
        host = randstrobes_query(read, params)
        rows = list(range(nf[i])) + list(range(150, 150 + nr[i]))
        assert h[i, rows].view(np.uint64).tolist() == host.hash.tolist()
        assert st[i, rows].tolist() == host.start.tolist()
        assert en[i, rows].tolist() == host.end.tolist()
    assert tie.sum() > 10


@pytest.fixture(scope="module")
def repeat_index():
    """tests/test_seed_device.py's lookup world: a 180 bp unit repeated
    120 times (long runs, wide buckets) in random sequence."""
    unit = random_dna(180, seed=31)
    genome = random_dna(25000, seed=11) + unit * 120 + random_dna(8000, seed=13)
    refs = JaxReferences()
    refs.add("c", genome.encode())
    index = JaxIndex(refs, JaxParams.from_read_length(150))
    index.populate(0.0002)
    r = random.Random(5)
    n = index.hashes.shape[0]
    keys = [int(index.hashes[r.randrange(n)]) for _ in range(500)]
    keys += [int(index.hashes[0])]  # the bucket table's quirk
    keys += [r.getrandbits(64) for _ in range(202)]  # misses
    return index, np.array(keys, dtype=np.uint64)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_split_lookups_match_jax(repeat_index):
    """split_hash_u64 and gary_iters as the JAX helpers; the binary split
    lookup and the G-ary lookup at G 4 and 16, pads of G and 1024 rows,
    the needed and two extra narrowing steps, and a 2-D query batch, all
    equal to the JAX functions and to StrobemerIndex.find."""
    index, keys = repeat_index
    want_pos = index.find(keys)
    hi, lo = psd.split_hash_u64(index.hashes)
    jhi, jlo = jsd.split_hash_u64(index.hashes)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo) and hi.dtype == jhi.dtype
    khi, klo = (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)
    b = index.randstrobe_start_indices
    bt = torch.from_numpy(b.view(np.int64))
    got = psd.index_find_device_split(_i32(hi), _i32(lo), bt, index.bits, _i32(khi), _i32(klo))
    jgot = np.asarray(jsd.index_find_device_split(jnp.asarray(hi), jnp.asarray(lo),
                                                  jnp.asarray(b), index.bits, jnp.asarray(khi),
                                                  jnp.asarray(klo)))
    assert np.array_equal(got.numpy(), jgot) and np.array_equal(jgot, want_pos)
    for G in (4, 16):
        iters = psd.gary_iters(b, G)
        assert iters == jsd.gary_iters(b, G) and iters >= 1
        for pad in (G, 1024):
            hi_p = np.concatenate([hi, np.full(pad, 0xFFFFFFFF, np.uint32)])
            lo_p = np.concatenate([lo, np.full(pad, 0xFFFFFFFF, np.uint32)])
            for it in (iters, iters + 2):
                got = psd.index_find_device_gary(_i32(hi_p), _i32(lo_p), bt, index.bits,
                                                 _i32(khi), _i32(klo), iters=it, G=G)
                jgot = np.asarray(jsd.index_find_device_gary(
                    jnp.asarray(hi_p), jnp.asarray(lo_p), jnp.asarray(b), index.bits,
                    jnp.asarray(khi), jnp.asarray(klo), iters=it, G=G))
                assert np.array_equal(got.numpy(), jgot) and np.array_equal(jgot, want_pos)
    got2d = psd.index_find_device_gary(_i32(hi_p), _i32(lo_p), bt, index.bits,
                                       _i32(khi.reshape(37, 19)), _i32(klo.reshape(37, 19)),
                                       iters=iters, G=16)
    assert np.array_equal(got2d.numpy(), want_pos.reshape(37, 19))
    assert (want_pos >= 0).sum() >= 500 and want_pos[500] == -1
