"""The port's host aligners and the BatchAligner's extend layout against
rabbitsalign_tpu's, exact: the numpy striped SSW, `Aligner.align` and
`align_from_ends`, the Python Hamming and the engine's `hamming_try` on
random and mutated pairs under three scorings; `ops_to_cigars` and
`unpack_output` on random packed rows; `extend_batch_packed` on the
CPU (the kernels' plain versions) against the JAX package's
`extend_batch_packed_portable`, byte for byte, at small buckets with
score-0, empty and more-than-RLE_M-run pairs; and `BatchAligner` on the
CPU against the JAX BatchAligner (its Pallas extend replaced by that
portable twin) and both packages' HostBatchAligner."""

import random

import numpy as np
import pytest
import torch

from rabbitsalign_tpu import native as jnative
from rabbitsalign_tpu.align import aligner as jaligner
from rabbitsalign_tpu.align import hamming as jhamming
from rabbitsalign_tpu.align import ssw as jssw
from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
from rabbitsalign_tpu.align.cigar import Cigar as JaxCigar
from rabbitsalign_tpu.ops import batch_extend as jbatch
from rabbitsalign_tpu.ops import extend_device as jextend
from rabbitsalign_tpu.ops.extend_portable import extend_batch_packed_portable
from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu_torch import native
from rabbitsalign_tpu_torch.align import aligner, hamming, ssw
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.align.cigar import Cigar
from rabbitsalign_tpu_torch.ops import batch_extend, extend_device
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams
from rabbitsalign_tpu_torch.utils.dna import encode

from .torch_extend_cases import batch_jobs, bucket_arrays, gap_pairs, mixed_pairs

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain extends at these batch widths run as fast on one thread as
    on eight; torch's intra-op threads would only crowd the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (match, mismatch, gap_open, gap_extend, end_bonus): the default, a
# softer one, and -O 1 -E 1 (open = extend, where NativePipeline keeps
# its extensions on the host and the BatchAligner does not)
SCORINGS = [(2, 8, 12, 1, 10), (1, 4, 6, 2, 5), (2, 8, 1, 1, 10)]
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _pairs(seed, n=14):
    """(query, ref) byte pairs: unrelated, planted with SNPs, with an
    indel, with an N run, and a query longer than its ref."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ref = rng.choice(ACGT, int(rng.randint(60, 240))).tobytes()
        kind = i % 5
        if kind == 0:
            q = rng.choice(ACGT, int(rng.randint(20, 150))).tobytes()
        else:
            st = int(rng.randint(0, len(ref) // 3))
            q = bytearray(ref[st:st + int(rng.randint(40, len(ref) - st + 1))])
            for p in rng.randint(0, len(q), int(rng.randint(0, 5))):
                q[p] = ACGT[rng.randint(4)]
            if kind == 2:
                cut = int(rng.randint(5, len(q) - 5))
                q = q[:cut] + q[cut + int(rng.randint(1, 5)):] if i % 2 else \
                    q[:cut] + bytes(rng.choice(ACGT, 3)) + q[cut:]
            elif kind == 3:
                p = int(rng.randint(0, len(q) - 6))
                q[p:p + 5] = b"NNNNN"
            elif kind == 4:
                q = bytes(rng.choice(ACGT, 7)) + q + bytes(rng.choice(ACGT, 9))
            q = bytes(q)
        out.append((q, ref))
    return out


def _info(a):
    return (list(a.cigar.ops), a.edit_distance, a.ref_start, a.ref_end, a.query_start,
            a.query_end, a.sw_score)


@pytest.mark.parametrize("scoring", SCORINGS)
def test_ssw_and_aligner_match_jax(scoring):
    A, B, O, E, bonus = scoring
    port_aln = aligner.Aligner(AlignmentParameters(A, B, O, E, bonus))
    jax_aln = jaligner.Aligner(JaxAlnParams(A, B, O, E, bonus))
    for q, ref in _pairs(sum(scoring)):
        got = ssw.ssw_align(encode(q), encode(ref), A, B, O, E)
        want = jssw.ssw_align(encode(q), encode(ref), A, B, O, E)
        assert (got.score1, got.ref_begin, got.ref_end, got.read_begin, got.read_end, got.flag,
                list(got.cigar.ops)) == (want.score1, want.ref_begin, want.ref_end,
                                         want.read_begin, want.read_end, want.flag,
                                         list(want.cigar.ops))
        assert _info(port_aln.align(q, ref)) == _info(jax_aln.align(q, ref))
        if got.score1 > 0:
            # the end-bonus post-processing of a device result: ends and
            # the =/X cigar of the clipped region
            cig, ed = aligner._eqx_and_mismatches(got, encode(q), encode(ref), len(q))
            inner = [op for op in cig.ops if op & 0xF != 4]
            args = (got.score1, got.read_begin, got.read_end + 1, got.ref_begin,
                    got.ref_end + 1)
            assert _info(port_aln.align_from_ends(q, ref, *args, Cigar(inner), ed)) == \
                _info(jax_aln.align_from_ends(q, ref, *args, JaxCigar(inner), ed))
    assert port_aln.calls_count() == jax_aln.calls_count() > 0


@pytest.mark.parametrize("scoring", SCORINGS)
def test_hamming_matches_jax(scoring, monkeypatch):
    """The Python Hamming and the engine's hamming_try on equal-length
    pairs with 0 to 12 mismatches (the gate passes below 5%)."""
    A, B, _, _, bonus = scoring
    rng = np.random.RandomState(A + B)
    n_gated = 0
    for i in range(40):
        ref = rng.choice(ACGT, int(rng.randint(1, 200))).tobytes()
        q = bytearray(ref)
        for p in rng.randint(0, len(q), i % 13):
            q[p] = ACGT[rng.randint(4)]
        q = bytes(q)
        assert hamming.hamming_distance(q, ref) == jhamming.hamming_distance(q, ref)
        assert _info(hamming.hamming_align(q, ref, A, B, bonus)) == \
            _info(jhamming.hamming_align(q, ref, A, B, bonus))
        got = native.hamming_try(q, ref, A, B, bonus)
        assert got == jnative.hamming_try(q, ref, A, B, bonus)
        n_gated += got is not False
    assert 5 < n_gated < 40
    assert native.hamming_try(b"", b"", A, B, bonus) is False
    monkeypatch.setenv("RABBITSALIGN_TPU_NO_NATIVE", "1")
    assert native.hamming_try(q, q, A, B, bonus) is None


def test_unpack_output_and_ops_to_cigars_match_jax():
    """Random packed rows with valid, empty, overflowed (0xFFFF), zero-
    score and corrupt (op 0 or 5..7, length 0) run tables."""
    rng = np.random.RandomState(5)
    M = extend_device.RLE_M
    B = 64
    out = rng.randint(0, 256, (extend_device.OUT_ROWS, B)).astype(np.uint8)
    n_runs = rng.randint(0, M + 1, B)
    n_runs[::9] = 0xFFFF
    ops = rng.randint(1, 5, (M, B))
    ops[rng.rand(M, B) < 0.01] = 0
    ops[rng.rand(M, B) < 0.01] = 6
    out[M:2 * M] = (ops << 5) | (out[M:2 * M] & 0x1F)
    out[M:2 * M, ::5] &= 0xE0
    out[:M, ::5] = 0  # length-0 runs
    out[2 * M + 12] = n_runs & 0xFF
    out[2 * M + 13] = n_runs >> 8
    out[2 * M + 1, ::7] = 0x80  # a negative score reads as a large u16
    out[2 * M, ::11] = 0
    out[2 * M + 1, ::11] = 0
    got = extend_device.unpack_output(out)
    want = jextend.unpack_output(out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    op_runs, len_runs, nr, score = got[0], got[1], got[2], got[3]
    gc = extend_device.ops_to_cigars(op_runs, len_runs, nr, score)
    wc = jextend.ops_to_cigars(op_runs, len_runs, nr, score)
    assert [None if c is None else (list(c[0].ops), c[1]) for c in gc] == \
        [None if c is None else (list(c[0].ops), c[1]) for c in wc]
    assert 5 < sum(c is None for c in gc) < B - 5


def _bucket_buffer(Q, T, pairs):
    arrays = bucket_arrays(pairs, Q, T)
    buf = extend_device.pack_input(*arrays)
    np.testing.assert_array_equal(buf, jextend.pack_input(*arrays))
    return buf


@pytest.mark.parametrize("Q,T,scoring", [(40, 72, SCORINGS[0]), (120, 168, SCORINGS[0]),
                                         (120, 168, SCORINGS[2])])
def test_extend_batch_packed_matches_portable(Q, T, scoring):
    """The plain path of extend_batch_packed against the JAX package's
    lax.scan twin, every byte of the (2*RLE_M + 14, B) rows. The pairs
    of `mixed_pairs` (planted, indel, N run, tandem, junk, empty, more
    than RLE_M runs from Q ~ 110) and `gap_pairs` (long gaps, walks off
    either edge, an all-N query that scores 0); T is not a multiple of
    16 in the first bucket."""
    A, B, O, E, _ = scoring
    pairs = mixed_pairs(Q, T, 21, seed=Q) + gap_pairs(Q, T, seed=T)
    buf = _bucket_buffer(Q, T, pairs)
    calls = extend_device.packed_calls
    got = extend_device.extend_batch_packed(torch.from_numpy(buf), Q, T, SwParams(A, B, O, E))
    assert extend_device.packed_calls == calls + 1
    want = np.asarray(extend_batch_packed_portable(buf, Q, T, JaxSwParams(A, B, O, E)))
    assert got.dtype == torch.uint8 and got.shape == (extend_device.OUT_ROWS, len(pairs))
    np.testing.assert_array_equal(got.numpy(), want)
    n_runs = extend_device.unpack_output(want)[2]
    score = extend_device.unpack_output(want)[3]
    assert (score == 0).any()
    if Q > 110:
        assert (n_runs == 0xFFFF).any()


def test_extend_batch_packed_refuses_a_wrong_layout():
    with pytest.raises(ValueError, match="uint8 buffer"):
        extend_device.extend_batch_packed(torch.zeros((10, 4), dtype=torch.uint8), 4, 4,
                                          SwParams(2, 8, 12, 1))


# -- the BatchAligner ------------------------------------------------------

@pytest.fixture(scope="module")
def genome():
    """tests/test_engine.py's genome."""
    rng = random.Random(99)
    return "".join(rng.choice("ACGT") for _ in range(300_000))


SMALL_BUCKETS = ((160, 256, 8), (160, 600, 8), (320, 1000, 8))


def _infos(results):
    return [_info(a) for a in results]


@pytest.mark.parametrize("scoring", [(2, 8, 12, 1, 10), (2, 8, 1, 1, 10)])
def test_batch_aligner_matches_jax_and_host(genome, scoring, monkeypatch):
    """BatchAligner(device="cpu") against the JAX BatchAligner with its
    Pallas extend swapped for extend_batch_packed_portable (only in this
    test, on the JAX module's name): equal at the default scoring and at
    -O 1 -E 1, jobs sent in two dispatches, the second while the first is
    pending. Against both packages' HostBatchAligner (the JAX docstring
    says the two give identical output): equal at the default scoring.
    At -O 1 -E 1, where NativePipeline keeps its extensions on the host
    and the BatchAligner has no such gate, not: where a gap opens for the
    price of an extension, the kernels and the SSW pick different paths
    of the same local score, so the cigar, the ends and then the
    end-bonus score of a few jobs differ."""
    jobs = batch_jobs(genome)
    monkeypatch.setattr(jbatch, "extend_batch_packed", extend_batch_packed_portable)
    gapped_open = scoring[2] > scoring[3]
    port = batch_extend.BatchAligner(AlignmentParameters(*scoring), 8, SMALL_BUCKETS,
                                     device="cpu")
    jax = jbatch.BatchAligner(JaxAlnParams(*scoring), 8, SMALL_BUCKETS)
    half = len(jobs) // 2
    tokens = []
    for part in (jobs[:half], jobs[half:]):
        for q, r in part:
            port.submit(q, r)
            jax.submit(q, r)
        tokens.append((port.dispatch(), jax.dispatch()))
    got = [x for t in tokens for x in _infos(port.collect(t[0]))]
    want = [x for t in tokens for x in _infos(jax.collect(t[1]))]
    assert got == want
    assert (port.n_device_jobs, port.n_fallbacks) == (jax.n_device_jobs, jax.n_fallbacks)
    assert port.n_fallbacks >= 1 and port.n_host_jobs == 2
    assert port.n_device_jobs + port.n_host_jobs == len(jobs)
    hosts = []
    for host in (batch_extend.HostBatchAligner(AlignmentParameters(*scoring)),
                 jbatch.HostBatchAligner(JaxAlnParams(*scoring))):
        for q, r in jobs:
            host.submit(q, r)
        hosts.append(_infos(host.flush()))
    assert hosts[0] == hosts[1]
    if gapped_open:
        assert got == hosts[0]
    else:
        assert got[-2:] != hosts[0][-2:]
        assert sum(g != h for g, h in zip(got, hosts[0])) < len(jobs) // 2


def test_batch_aligner_golden_check(genome, monkeypatch):
    """golden_check holds each device result's score to the host SSW's:
    it passes at both scorings (the tie jobs of -O 1 -E 1 differ in their
    cigars, not their scores) and trips when the host's score differs."""
    jobs = batch_jobs(genome)[-6:]
    for scoring in ((2, 8, 12, 1, 10), (2, 8, 1, 1, 10)):
        ba = batch_extend.BatchAligner(AlignmentParameters(*scoring), 8, SMALL_BUCKETS,
                                       golden_check=True, device="cpu")
        for q, r in jobs:
            ba.submit(q, r)
        assert len(ba.flush()) == len(jobs)

    class OffByOne(batch_extend.Aligner):
        def align(self, query, ref):
            info = super().align(query, ref)
            info.sw_score += 1
            return info

    monkeypatch.setattr(batch_extend, "Aligner", OffByOne)
    ba = batch_extend.BatchAligner(AlignmentParameters(), 8, SMALL_BUCKETS, golden_check=True,
                                   device="cpu")
    ba.submit(*jobs[-1])
    with pytest.raises(AssertionError):
        ba.flush()


def test_batch_aligner_wants_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_extend.BatchAligner(AlignmentParameters())
