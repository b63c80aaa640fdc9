"""The port's fused extend against the JAX package's, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side is its own CPU path (the lax.scan twins of the Pallas
kernels). Every input is integer and made from a seed, so every
comparison is exact: the packed (2*RLE_M + 14, B) outputs must be equal
byte for byte. The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py, which needs a GPU.
"""

import random

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.native.engine import engine_buckets as jax_engine_buckets
from rabbitsalign_tpu.ops import extend_device as jx
from rabbitsalign_tpu.ops.extend_portable import (
    extend_batch_packed_resident_q2_portable,
    traceback_rle,
)
from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu.ops.sw_jax import sw_forward as jax_sw_forward
from rabbitsalign_tpu.utils.dna import encode
from rabbitsalign_tpu_torch.native.engine import engine_buckets
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams

from .test_ops import _extend_parity_pairs, _mutate, _pack
from .torch_extend_cases import mixed_pairs, q2_batch
from .util import random_dna

DEFAULT = SwParams(2, 8, 12, 1)
SW_PARAMS = [
    SwParams(2, 8, 12, 1),   # defaults
    SwParams(1, 1, 2, 1),    # flat scoring: dense score ties
    SwParams(3, 2, 3, 0),    # free gap extension
]


def _q2_batch(pairs, Q, seed=0):
    return q2_batch([(_as_codes(q), _as_codes(t)) for q, t in pairs], Q, seed)


def _as_codes(x) -> np.ndarray:
    return encode(x) if isinstance(x, str) else np.asarray(x, dtype=np.uint8)


def _extend_both(buf, genome, Q, T, sw):
    jax_out = np.asarray(extend_batch_packed_resident_q2_portable(
        buf, jx.pack_ref_pages(genome), Q, T, JaxSwParams(*sw), buf.shape[1]))
    port_out = px.extend_batch_packed_resident_q2(
        torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T, sw,
        buf.shape[1])
    assert port_out.dtype == torch.uint8 and port_out.shape == (px.OUT_ROWS, buf.shape[1])
    return jax_out, port_out.numpy()


def _adversarial_pairs(Q, T, B):
    """The 5-mode adversarial set of tests/test_ops.py: planted, tandem
    repeats, N runs, homopolymers, junk with N codes."""
    rng = np.random.RandomState(99)
    pyr = random.Random(5150)
    pairs = []
    for b in range(B):
        mode = b % 5
        m = pyr.randrange(30, 151)
        n = pyr.randrange(m, min(T, m + 120))
        if mode == 0:
            q = rng.randint(0, 4, m).astype(np.uint8)
            t = rng.randint(0, 4, n).astype(np.uint8)
            st = pyr.randrange(0, n - m + 1)
            t[st:st + m] = q
            for _ in range(m // 15):
                t[st + pyr.randrange(m)] = pyr.randrange(4)
        elif mode == 1:
            u = pyr.randrange(3, 20)
            q = (np.arange(m) % u % 4).astype(np.uint8)
            t = (np.arange(n) % u % 4).astype(np.uint8)
        elif mode == 2:
            q = rng.randint(0, 4, m).astype(np.uint8)
            p = pyr.randrange(0, max(1, m - 9))
            q[p:p + pyr.randrange(2, 8)] = 4
            t = rng.randint(0, 4, n).astype(np.uint8)
            st = pyr.randrange(0, n - m + 1)
            t[st:st + m] = np.where(q == 4, rng.randint(0, 4, m).astype(np.uint8), q)
        elif mode == 3:
            q = np.zeros(m, np.uint8)
            t = np.zeros(n, np.uint8)
            for _ in range(4):
                t[pyr.randrange(n)] = pyr.randrange(4)
        else:
            q = rng.randint(0, 5, m).astype(np.uint8)
            t = rng.randint(0, 5, n).astype(np.uint8)
        pairs.append((q[:Q], t[:T]))
    return pairs


def _bucket_pairs(Q, T, B, seed):
    """Planted pairs with indels, sized up to the bucket's caps, plus an
    empty and a junk pair."""
    r = random.Random(seed)
    pairs = []
    for i in range(B - 2):
        m = r.randint(Q // 2, Q)
        core = random_dna(m, seed=seed * 1000 + i)
        q = _mutate(core, r, r.randint(0, 6), r.randint(0, 2), r.randint(0, 2))[:Q]
        flank = max(0, T - len(core))
        t = (random_dna(r.randint(0, flank // 2), seed=i) + core
             + random_dna(r.randint(0, flank // 2), seed=i + 1))[:T]
        pairs.append((q, t))
    pairs += [("", random_dna(T // 2, seed=3)), (random_dna(Q, seed=4), random_dna(T, seed=5))]
    return pairs


@pytest.mark.parametrize("sw", SW_PARAMS, ids=["default", "flat", "free-extend"])
def test_extend_parity_pairs_match_jax(sw):
    """Planted, junk, empty and >RLE_M-run pairs at (256, 512)."""
    Q, T = 256, 512
    buf, genome = _q2_batch(_extend_parity_pairs(Q, T), Q)
    jax_out, port_out = _extend_both(buf, genome, Q, T, sw)
    np.testing.assert_array_equal(port_out, jax_out)
    n_runs = px.unpack_output(port_out)[2]
    if sw == DEFAULT:
        assert (n_runs == 0xFFFF).any(), "the overflow pair must hit the 0xFFFF marker"


def test_extend_adversarial_matches_jax():
    Q, T, B = 152, 256, 128
    buf, genome = _q2_batch(_adversarial_pairs(Q, T, B), Q, seed=1)
    jax_out, port_out = _extend_both(buf, genome, Q, T, DEFAULT)
    np.testing.assert_array_equal(port_out, jax_out)
    assert (px.unpack_output(port_out)[3] > 0).sum() > B // 2


@pytest.mark.parametrize("Q,T", [(q, t) for q, t, _, _ in engine_buckets(150)])
def test_extend_engine_buckets_match_jax(Q, T):
    buf, genome = _q2_batch(_bucket_pairs(Q, T, 8, seed=Q + T), Q, seed=2)
    jax_out, port_out = _extend_both(buf, genome, Q, T, DEFAULT)
    np.testing.assert_array_equal(port_out, jax_out)


def test_extend_mixed_pairs_match_jax():
    """The pair mix chip_smoke.py runs on the GPU (planted, indel, N-run,
    tandem, junk, empty, overflow), at the tight bucket."""
    Q, T = 152, 256
    buf, genome = q2_batch(mixed_pairs(Q, T, 56, seed=4), Q, seed=4)
    jax_out, port_out = _extend_both(buf, genome, Q, T, DEFAULT)
    np.testing.assert_array_equal(port_out, jax_out)
    assert (px.unpack_output(port_out)[2] == 0xFFFF).any()


def test_engine_buckets_match_jax():
    assert engine_buckets(150) == jax_engine_buckets(150)
    assert engine_buckets(250) == jax_engine_buckets(250)


def test_extend_window_at_genome_end_matches_jax():
    """Target windows that run past the genome's end (and one offset past
    the padding, where the gather clamps) read the JAX package's bytes,
    and the q2 unpack agrees field by field."""
    Q, T = 152, 256
    rng = np.random.RandomState(7)
    genome = rng.randint(0, 4, 5000).astype(np.uint8)
    n = genome.shape[0]
    cases = [(n - 40, 120), (n - 1, 200), (n, 60), (n + 4000, 200), (n - 256, 256)]
    pairs = []
    for i, (start, tlen) in enumerate(cases):
        q = genome[max(0, min(start, n - 100)):][:100].copy()
        q[::17] = (q[::17] + 1) % 4
        pairs.append((q, np.zeros(tlen, np.uint8)))
    while len(pairs) % 8:
        pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
    buf, _ = _q2_batch(pairs, Q)
    Qp, Qm = (Q + 3) // 4, (Q + 7) // 8
    for b, (start, _) in enumerate(cases):
        buf[Qp + Qm + 4:Qp + Qm + 8, b] = [(start >> s) & 0xFF for s in (0, 8, 16, 24)]

    jq, jt, jql, jtl = map(np.asarray, jax.jit(jx.unpack_q2, static_argnums=(2, 3))(
        buf, jx.pack_ref_pages(genome), Q, T))
    pq, pt, pql, ptl = (x.numpy() for x in px.unpack_q2(
        torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T))
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pql, jql)
    np.testing.assert_array_equal(ptl, jtl)
    assert (pt[:, 3] == 4).all()  # the window at the padding reads 'N'

    jax_out, port_out = _extend_both(buf, genome, Q, T, DEFAULT)
    np.testing.assert_array_equal(port_out, jax_out)


def test_pack_ref_pages_matches_jax():
    rng = np.random.RandomState(3)
    for n in (0, 1, 1000, 70_000):
        codes = rng.randint(0, 5, n).astype(np.uint8)
        np.testing.assert_array_equal(px.pack_ref_pages(codes), jx.pack_ref_pages(codes))
        flat = px.resident_ref_codes(codes, "cpu").numpy()
        np.testing.assert_array_equal(flat, jx.pack_ref_pages(codes)[0][: flat.shape[0]])


def _small_pairs():
    r = random.Random(31)
    Q, T = 64, 128
    pairs = []
    for i in range(24):
        core = random_dna(r.randint(30, 60), seed=500 + i)
        q = _mutate(core, r, r.randint(0, 4), r.randint(0, 1), r.randint(0, 1))[:Q]
        t = (random_dna(r.randint(0, 30), seed=i) + core
             + random_dna(r.randint(0, 30), seed=i + 1))[:T]
        pairs.append((q, t))
    pairs += [(random_dna(50, seed=1), random_dna(100, seed=2)), ("", "ACGT"),
              ("NNNACGTNN", "NNNACGTNN")]
    return pairs, Q, T


def test_forward_plain_matches_sw_jax():
    """score, t_end and q_end equal; dirs equal on every valid cell
    (sw_jax keeps (D, B, Q) planes, the port (B, Q, T))."""
    pairs, Q, T = _small_pairs()
    qc, tc, ql, tl = _pack(pairs, Q, T)
    for sw in SW_PARAMS:
        js, jte, jqe, jd = map(np.asarray, jax_sw_forward(qc, tc, ql, tl, JaxSwParams(*sw)))
        ps, pte, pqe, pd = (x.numpy() for x in sw_cuda.sw_forward_plain(
            torch.from_numpy(qc.T.copy()), torch.from_numpy(tc.T.copy()),
            torch.from_numpy(ql), torch.from_numpy(tl), sw))
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pte, jte)
        np.testing.assert_array_equal(pqe, jqe)
        for b in range(len(pairs)):
            qs, ts = np.meshgrid(np.arange(ql[b]), np.arange(tl[b]), indexing="ij")
            np.testing.assert_array_equal(pd[b, qs, ts], jd[qs + ts, b, qs])
    assert ps[len(pairs) - 2] == 0 and pte[len(pairs) - 2] == -1 and pqe[len(pairs) - 2] == 0


def test_walk_plain_matches_traceback_rle():
    pairs, Q, T = _small_pairs()
    qc, tc, ql, tl = _pack(pairs, Q, T)
    js, jte, jqe, jd = jax_sw_forward(qc, tc, ql, tl, JaxSwParams(*DEFAULT))
    j_runs_op, j_runs_len, j_meta = map(np.asarray, traceback_rle(jd, js, jte, jqe))
    fwd = sw_cuda.sw_forward_plain(
        torch.from_numpy(qc.T.copy()), torch.from_numpy(tc.T.copy()),
        torch.from_numpy(ql), torch.from_numpy(tl), DEFAULT)
    p_runs_op, p_runs_len, p_meta = (x.numpy() for x in tb_cuda.sw_traceback_plain(
        fwd[3], *fwd[:3]))
    np.testing.assert_array_equal(p_runs_op, j_runs_op)
    np.testing.assert_array_equal(p_runs_len, j_runs_len)
    np.testing.assert_array_equal(p_meta, j_meta)


def test_wrappers_take_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; any other
    non-CUDA device is refused."""
    pairs, Q, T = _small_pairs()
    qc, tc, ql, tl = (torch.from_numpy(np.ascontiguousarray(x))
                      for x in _pack(pairs, Q, T))
    q_t, t_t = qc.T.contiguous(), tc.T.contiguous()
    before = (sw_cuda.launches, tb_cuda.launches)
    score, t_end, q_end, dirs = sw_cuda.sw_forward(q_t, t_t, ql, tl, DEFAULT)
    tb_cuda.sw_traceback(dirs, score, t_end, q_end)
    assert (sw_cuda.launches, tb_cuda.launches) == before
    with pytest.raises(ValueError):
        sw_cuda.sw_forward(q_t.to("meta"), t_t.to("meta"), ql.to("meta"),
                           tl.to("meta"), DEFAULT)
    with pytest.raises(ValueError):
        tb_cuda.sw_traceback(dirs.to("meta"), score.to("meta"),
                             t_end.to("meta"), q_end.to("meta"))


@pytest.mark.parametrize("sw", SW_PARAMS, ids=["default", "flat", "free-extend"])
def test_walk_plain_matches_traceback_rle_mixed(sw):
    """The plain walk over the (B, Q, T) dirs of the plain forward gives
    traceback_rle's runs and meta over sw_jax's (D, B, Q) dirs, on the
    mixed pairs (>32-run, N-run, tandem, empty) with Q not a multiple of
    32 and lengths of 0, Q and T, and past them."""
    Q, T, B = 40, 72, 28
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=9), Q, seed=9)
    q_t, t_t, qlen, tlen = px.unpack_q2(torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"),
                                        Q, T)
    qlen[1], tlen[2], qlen[3], tlen[3], qlen[4], tlen[4] = 0, 0, Q, T, Q + 7, T + 3
    js, jte, jqe, jd = jax_sw_forward(q_t.numpy().T.copy(), t_t.numpy().T.copy(),
                                      qlen.numpy(), tlen.numpy(), JaxSwParams(*sw))
    j_walk = map(np.asarray, traceback_rle(jd, js, jte, jqe))
    fwd = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
    assert fwd[3].shape == (B, Q, T)
    np.testing.assert_array_equal(fwd[0].numpy(), np.asarray(js))
    for p, j in zip(tb_cuda.sw_traceback_plain(fwd[3], *fwd[:3]), j_walk):
        np.testing.assert_array_equal(p.numpy(), j)


def test_permute_dirs_and_valid_cells():
    """permute_dirs puts cell (b, q, t) at [q + t, q, b] ("dqb", Dpad =
    Q + T - 1 rounded up to 8, 0 elsewhere) and takes no other layout;
    valid_cells marks q < qlen and t < tlen."""
    rng = np.random.RandomState(2)
    B, Q, T = 5, 13, 21
    dirs = torch.from_numpy(rng.randint(1, 256, (B, Q, T)).astype(np.uint8))
    dqb = sw_cuda.permute_dirs(dirs, "dqb").numpy()
    assert dqb.shape == (40, Q, B)
    d = dirs.numpy()
    seen = np.zeros(dqb.shape, bool)
    for b in range(B):
        for q in range(Q):
            for t in range(T):
                assert dqb[q + t, q, b] == d[b, q, t]
                seen[q + t, q, b] = True
    assert (dqb[~seen] == 0).all()
    for layout in ("tqb", "qtb"):
        with pytest.raises(ValueError):
            sw_cuda.permute_dirs(dirs, layout)
    qlen = torch.tensor([0, 4, 13, 20, -1], dtype=torch.int32)
    tlen = torch.tensor([5, 0, 21, 9, 3], dtype=torch.int32)
    valid = sw_cuda.valid_cells(qlen, tlen, Q, T)
    assert valid.shape == (B, Q, T)
    assert [int(v.sum()) for v in valid] == [0, 0, Q * T, Q * 9, 0]
