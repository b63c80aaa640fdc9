"""The port's CUDA kernels against their plain PyTorch versions on the
same GPU inputs, exact, at every engine bucket shape (the extend) and at
B = 1, 33 and 4096 reads (seeding and lookup), the sharded index's run
lookup at 1 and 4 shards of one card, and the 3-worker pipeline, the
default run's seeding on the card against host seeding and --shard-index
on the GPU against one worker and the default run, the multi-host pod's split index and a two-process pod on
the card, and a device list of several entries (two of the one card; every
card where there are two or more): the round-robin extend, the genome
a card, the workers' streams a card and the shards a card against the CPU;
and the device NAM front end's kernels (the exact syncmer scan, the merge,
the run walk) and its entry points against their plain versions and the
host find_nams; and the Python mapper's extend layout
(`extend_batch_packed`) at its three buckets and BatchAligner("cuda")
against the CPU and the host aligner, with no plain version on the card;
and the resident (query-only), grouped and unpacked extends and
`data_parallel_extend` against the CPU.
Needs an NVIDIA GPU and nvcc;
skips without one. This file imports neither jax nor rabbitsalign_tpu,
so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import re
import threading

import numpy as np
import pytest
import torch

from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.native.engine import engine_buckets
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import int16_probe as probe
from rabbitsalign_tpu_torch.ops import seed_cuda, seed_device, sw_cuda, tb_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams

from .torch_chain_cases import (chain_reads, composed_reads, merge_edge_streams,
                                mixed_merge_streams, mixed_runs, nam_key, stream_tensors,
                                synthetic_streams, wide_streams, world_genome)
from .torch_extend_cases import (READ_LEN, gap_pairs, mixed_pairs, q2_batch, q2_edge_batch,
                                 revcomp, sim_read, write_fastq, write_pe250)
from .torch_gather_lanes import RunsIndex
from .torch_seed_cases import code_batch, edge_reads, long_scan_reads, sampled_reads, tie_reads
from .util import random_dna


# the engine's buckets at r = 150, and the tight bucket of 250-base reads,
# (256, 360): the forward at R = 8 with T = 360
BUCKET_SHAPES = ([(q, t) for q, t, _, _ in engine_buckets(150)]
                 + [engine_buckets(250)[0][:2]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _valid(Q, T, qlen, tlen, device):
    """(B, Q, T): the cells the forward's dirs define."""
    return sw_cuda.valid_cells(qlen, tlen, Q, T)


def _codes(Q, T, B, seed, device):
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=seed), Q, seed=seed)
    return px.unpack_q2(torch.from_numpy(buf).to(device), px.resident_ref_codes(genome, device),
                        Q, T)


def _assert_forward_equal(got, want, valid):
    for k, p in zip(got[:3], want[:3]):
        assert torch.equal(k, p)
    assert got[3].shape == want[3].shape
    assert torch.equal(torch.where(valid, got[3], 0), torch.where(valid, want[3], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", BUCKET_SHAPES)
@pytest.mark.parametrize("sw", [SwParams(2, 8, 12, 1), SwParams(1, 1, 2, 1)],
                         ids=["default", "flat"])
def test_kernels_match_plain_versions(cuda, Q, T, sw):
    buf, genome = q2_batch(mixed_pairs(Q, T, 70, seed=Q), Q, seed=Q)
    q_t, t_t, qlen, tlen = px.unpack_q2(
        torch.from_numpy(buf).to(cuda), px.resident_ref_codes(genome, cuda), Q, T)

    launches = sw_cuda.launches
    kernel = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    assert sw_cuda.launches == launches + 1
    plain = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
    for k, p in zip(kernel[:3], plain[:3]):
        assert torch.equal(k, p)
    assert torch.equal(torch.where(_valid(Q, T, qlen, tlen, cuda), kernel[3], 0), plain[3])

    launches = tb_cuda.launches
    walk = tb_cuda.sw_traceback(kernel[3], *kernel[:3])
    assert tb_cuda.launches == launches + 1
    for k, p in zip(walk, tb_cuda.sw_traceback_plain(kernel[3], *kernel[:3])):
        assert torch.equal(k, p)
    packed = tb_cuda.sw_traceback_packed(kernel[3], *kernel[:3])
    assert tb_cuda.launches == launches + 2
    assert torch.equal(packed, tb_cuda.sw_traceback_packed_plain(kernel[3], *kernel[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", BUCKET_SHAPES)
@pytest.mark.parametrize("acc", ["int32", "int16"])
def test_q2_forward_matches_unpack_and_forward(cuda, monkeypatch, Q, T, acc):
    """The forward's q2 loader on the card (`sw_forward_q2`, which decodes
    the upload and gathers the targets in its prologue) equals `unpack_q2`
    then `sw_forward` (the codes loader) byte for byte: score, t_end, q_end
    and the dirs on valid cells, in int32 and int16, at every bucket, on
    `q2_edge_batch`'s N codes, lengths at 0, at the bucket and past it and
    windows at the genome's end (against the genome itself, where the
    clamp repeats its last code, and its resident copy), B = 70 (not a
    multiple of a block's 4 warps); one launch of the dtype's kernel."""
    monkeypatch.setenv("RSB_SW16", "1" if acc == "int16" else "0")
    sw = SwParams(2, 8, 12, 1)
    assert sw_cuda.pick_dtype(Q, T, sw) == getattr(torch, acc)
    buf, genome = q2_edge_batch(Q, T, 70, seed=Q + T)
    buf = torch.from_numpy(buf).to(cuda)
    for ref in (torch.from_numpy(genome).to(cuda), px.resident_ref_codes(genome, cuda)):
        q_t, t_t, qlen, tlen = px.unpack_q2(buf, ref, Q, T)
        want = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
        before = (sw_cuda.launches, sw_cuda.launches_i16)
        got = sw_cuda.sw_forward_q2(buf, ref, Q, T, sw)
        assert (sw_cuda.launches, sw_cuda.launches_i16) == (
            before[0] + (acc == "int32"), before[1] + (acc == "int16"))
        _assert_forward_equal(got, want, _valid(Q, T, qlen, tlen, cuda))
        assert (got[0] > 0).sum() > 20 and [int(x[i]) for i in (1, 2) for x in got[:3]] == [
            0, -1, 0] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", BUCKET_SHAPES)
def test_native_enqueue_matches_the_resident_q2_extend(cuda, monkeypatch, Q, T):
    """One native enqueue (`extend_q2_enqueue`: the upload from the pinned
    block, the q2 forward, the packed traceback and the copy back, on the
    current stream, here one of its own) writes the packed output of
    `extend_batch_packed_resident_q2` on the same batch into the block,
    byte for byte, in int32 and int16, with windows at the genome's end;
    each counts one call and one launch of each kernel. A batch that is not
    a `q2_staging` view is refused."""
    sw = SwParams(2, 8, 12, 1)
    buf, genome = q2_edge_batch(Q, T, 70, seed=Q)
    ref = px.resident_ref_codes(genome, cuda)
    stream = torch.cuda.Stream(cuda)
    for sw16 in ("0", "1"):
        monkeypatch.setenv("RSB_SW16", sw16)
        want = px.extend_batch_packed_resident_q2(torch.from_numpy(buf).to(cuda), ref, Q, T, sw,
                                                  64).cpu().numpy()
        staged = px.q2_staging(Q, buf.shape[1])
        staged[...] = buf
        staged.base[staged.size:] = 0xAB
        before = (px.calls, sw_cuda.launches, sw_cuda.launches_i16, tb_cuda.launches)
        with torch.cuda.stream(stream):
            out = px.extend_q2_enqueue(staged, ref, Q, T, sw)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        assert np.array_equal(out, want) and out.base is staged.base
        assert np.array_equal(staged, buf)
        assert (px.calls, sw_cuda.launches, sw_cuda.launches_i16, tb_cuda.launches) == (
            before[0] + 1, before[1] + (sw16 == "0"), before[2] + (sw16 == "1"), before[3] + 1)
    with pytest.raises(ValueError, match="q2_staging"):
        px.extend_q2_enqueue(buf.copy(), ref, Q, T, sw)


@pytest.mark.cuda
def test_native_enqueue_refuses_a_short_scratch(cuda):
    """The enqueue's entry returns an error and enqueues nothing for a
    scratch one byte short of `enqueue_scratch_bytes` or a bucket over
    512 rows; for B = 0 it succeeds with nothing to do. The library's
    scratch size is dirs, three result rows, the q2 rows and the packed
    rows, each from a 16-byte boundary."""
    from rabbitsalign_tpu_torch.ops.cuda_build import load_kernels

    Q, T = 152, 256
    buf, genome = q2_edge_batch(Q, T, 12)
    ref = px.resident_ref_codes(genome, cuda)
    staged = px.q2_staging(Q, 12)
    staged[...] = buf
    staged.base[staged.size:] = 7
    stream = torch.cuda.current_stream(cuda)
    lib = load_kernels()
    need = px.enqueue_scratch_bytes(Q, T, 12)

    def a16(n):
        return -(-n // 16) * 16

    assert need == a16(12 * Q * T) + a16(12 * 12) + a16(px.q2_rows(Q) * 12) + px.OUT_ROWS * 12
    with pytest.raises(ValueError):
        px.enqueue_scratch_bytes(513, T, 12)
    scratch = torch.empty(need, dtype=torch.uint8, device=cuda)
    for q, b, n in ((Q, 12, need - 1), (513, 12, need << 2), (Q, 0, 0)):
        err = lib.extend_q2_enqueue(staged.ctypes.data, scratch.data_ptr(), n,
                                    ref.data_ptr(), ref.shape[0], q, T, b, 2, 8, 12, 1, 0,
                                    cuda.index or 0, stream.cuda_stream)
        assert (err != 0) == (b != 0)
    torch.cuda.synchronize()
    assert (staged.base[staged.size:] == 7).all()


TB_SHAPES = BUCKET_SHAPES + [(40, 72), (13, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", TB_SHAPES)
@pytest.mark.parametrize("B", [0, 1, 33])
def test_traceback_edges_match_plain(cuda, Q, T, B):
    """Both traceback epilogues at every bucket and at T not a multiple of
    16 (the byte-copy path), at B = 0, 1 and 33 (a ragged last block, whose
    packed rows go out a byte at a time), on pairs whose walks leave tiles
    sideways (long insertion and deletion runs) and walk off at q = 0 and at
    t = 0: equal to their plain versions, one launch a call (none for B = 0)."""
    pairs = (gap_pairs(Q, T, seed=B) + mixed_pairs(Q, T, B, seed=Q))[:B]
    buf, genome = q2_batch(pairs, Q, seed=Q)
    q_t, t_t, qlen, tlen = px.unpack_q2(
        torch.from_numpy(buf).to(cuda), px.resident_ref_codes(genome, cuda), Q, T)
    score, t_end, q_end, dirs = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, SwParams(2, 8, 12, 1))
    launches = tb_cuda.launches
    walk = tb_cuda.sw_traceback(dirs, score, t_end, q_end)
    packed = tb_cuda.sw_traceback_packed(dirs, score, t_end, q_end)
    assert tb_cuda.launches == launches + 2 * (B > 0)
    for k, p in zip(walk, tb_cuda.sw_traceback_plain(dirs, score, t_end, q_end)):
        assert torch.equal(k, p)
    assert packed.shape == (tb_cuda.OUT_ROWS, B)
    assert torch.equal(packed, tb_cuda.sw_traceback_packed_plain(dirs, score, t_end, q_end))
    if B > 1:
        assert int((score > 0).sum()) > B // 2


@pytest.mark.cuda
@pytest.mark.parametrize("sw", [SwParams(2, 8, 12, 1), SwParams(1, 1, 2, 1)],
                         ids=["default", "flat"])
def test_api_extends_on_cuda_match_cpu(cuda, monkeypatch, sw):
    """The resident (query-only layout), grouped and unpacked extends and
    `data_parallel_extend` on the card (over [cuda:0] and [cuda:0, cuda:0])
    equal their CPU results, with windows at the genome's end; each
    launches the kernels (the unpacked walk through `sw_traceback`)."""
    from rabbitsalign_tpu_torch.parallel.sharding import data_parallel_extend

    monkeypatch.delenv("RSB_SW16", raising=False)
    Q, T = 152, 256
    pairs = mixed_pairs(Q, T, 90, seed=16) + gap_pairs(Q, T, 16)
    buf_q2, genome = q2_batch(pairs, Q, seed=16)
    B = buf_q2.shape[1]
    q_t, t_t, qlen, tlen = px.unpack_q2(torch.from_numpy(buf_q2),
                                        px.resident_ref_codes(genome, "cpu"), Q, T)
    tstart = torch.from_numpy(buf_q2[-4:].astype(np.int64))
    tstart = tstart[0] | (tstart[1] << 8) | (tstart[2] << 16) | (tstart[3] << 24)
    tstart[-3:] = torch.tensor([genome.shape[0] - 40, genome.shape[0] - 1, genome.shape[0] - 100])
    t_t = px.gather_targets(px.resident_ref_codes(genome, "cpu"),
                            torch.stack([(tstart >> (8 * i)) & 0xFF for i in range(4)]), tlen, T)
    buf_q = torch.cat([q_t, torch.stack([qlen & 0xFF, qlen >> 8, tlen & 0xFF, tlen >> 8]).to(
        torch.uint8), torch.stack([(tstart >> (8 * i)) & 0xFF for i in range(4)]).to(torch.uint8)])
    buf = torch.from_numpy(px.pack_input(q_t.numpy(), t_t.numpy(), qlen.numpy(), tlen.numpy()))
    want = px.extend_batch_packed(buf, Q, T, sw)
    assert torch.equal(px.extend_batch_packed_resident(buf_q, px.resident_ref_codes(genome, "cpu"),
                                                       Q, T, sw, 64), want)
    f0, t0 = sw_cuda.launches, tb_cuda.launches
    got = {"resident": px.extend_batch_packed_resident(
               buf_q.to(cuda), px.resident_ref_codes(genome, cuda), Q, T, sw, 64),
           "grouped": px.extend_batch_packed_grouped(buf.to(cuda), Q, T, sw, 7)}
    for name, out in got.items():
        assert torch.equal(out.cpu(), want), name
    dev = px.extend_batch_device(q_t.to(cuda), t_t.to(cuda), qlen.to(cuda), tlen.to(cuda), sw)
    cpu = px.extend_batch_device(q_t, t_t, qlen, tlen, sw)
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)
    assert (sw_cuda.launches, tb_cuda.launches) == (f0 + 3, t0 + 3)
    n = B - B % 2
    args = (q_t[:, :n].T, t_t[:, :n].T, qlen[:n], tlen[:n])
    want_dp = data_parallel_extend(["cpu"], sw, *args)
    for devices in ([cuda], [cuda, cuda]):
        got_dp = data_parallel_extend(devices, sw, *(x.to(cuda) for x in args))
        for a, b in zip(got_dp, want_dp):
            assert torch.equal(a.cpu(), b)
    assert sw_cuda.launches == f0 + 6


@pytest.mark.cuda
def test_fused_extend_packs_in_the_traceback_kernel(cuda, monkeypatch):
    """The fused extend on the card equals its plain composition on the CPU
    with every torch pack and plain walk made to raise: nothing runs after
    the traceback kernel, which writes the transfer buffer itself."""
    Q, T = 152, 256
    sw = SwParams(2, 8, 12, 1)
    buf, genome = q2_batch(mixed_pairs(Q, T, 70, seed=5) + gap_pairs(Q, T, 5), Q, seed=5)
    B = buf.shape[1]
    want = px.extend_batch_packed_resident_q2(
        torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T, sw, B)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused extend ran a plain pack or walk on the card")

    for mod, name in ((px, "_pack_rle_output"), (tb_cuda, "pack_rle_output"),
                      (tb_cuda, "sw_traceback_plain"), (tb_cuda, "sw_traceback_packed_plain")):
        monkeypatch.setattr(mod, name, refuse)
    launches = tb_cuda.launches
    got = px.extend_batch_packed_resident_q2(torch.from_numpy(buf).to(cuda),
                                             px.resident_ref_codes(genome, cuda), Q, T, sw, B)
    assert tb_cuda.launches == launches + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", BUCKET_SHAPES)
def test_int16_kernel_matches_plain_and_int32_kernel(cuda, monkeypatch, Q, T):
    buf, genome = q2_batch(mixed_pairs(Q, T, 70, seed=Q), Q, seed=Q)
    q_t, t_t, qlen, tlen = px.unpack_q2(
        torch.from_numpy(buf).to(cuda), px.resident_ref_codes(genome, cuda), Q, T)
    sw = SwParams(2, 8, 12, 1)
    valid = _valid(Q, T, qlen, tlen, cuda)

    monkeypatch.setenv("RSB_SW16", "1")
    assert sw_cuda.pick_dtype(Q, T, sw) == torch.int16
    launches, launches_i16 = sw_cuda.launches, sw_cuda.launches_i16
    k16 = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    assert (sw_cuda.launches, sw_cuda.launches_i16) == (launches, launches_i16 + 1)
    plain16 = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, torch.int16)
    monkeypatch.delenv("RSB_SW16")
    k32 = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    assert sw_cuda.launches == launches + 1
    for other in (plain16, k32):
        for k, p in zip(k16[:3], other[:3]):
            assert torch.equal(k, p)
        assert torch.equal(torch.where(valid, k16[3], 0), torch.where(valid, other[3], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", BUCKET_SHAPES)
@pytest.mark.parametrize("split", sw_cuda.SPLITS)
def test_split_kernel_matches_plain_and_one_pair_kernel(cuda, monkeypatch, Q, T, split):
    """The split kernels (2 and 4 pairs a warp) against their plain
    version and the production forward (one warp per pair), dirs (B, Q, T)
    on valid cells."""
    monkeypatch.delenv("RSB_SW16", raising=False)
    buf, genome = q2_batch(mixed_pairs(Q, T, 72, seed=Q + split), Q, seed=Q)
    q_t, t_t, qlen, tlen = px.unpack_q2(
        torch.from_numpy(buf).to(cuda), px.resident_ref_codes(genome, cuda), Q, T)
    sw = SwParams(2, 8, 12, 1)
    valid = _valid(Q, T, qlen, tlen, cuda)
    launches = sw_cuda.launches_split
    got = sw_cuda.sw_forward_split(q_t, t_t, qlen, tlen, sw, split)
    assert sw_cuda.launches_split == launches + 1
    production = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    for other in (sw_cuda.sw_forward_split_plain(q_t, t_t, qlen, tlen, sw, split), production):
        _assert_forward_equal(got, other, valid)
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_split(q_t[:, :70], t_t[:, :70], qlen[:70], tlen[:70], sw, 4)
    assert sw_cuda.launches_split == launches + 1


EDGE_SHAPES = BUCKET_SHAPES + [(24, 40), (33, 47), (100, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", EDGE_SHAPES)
@pytest.mark.parametrize("acc", ["int32", "int16"])
def test_forward_edges_match_plain_and_split(cuda, monkeypatch, Q, T, acc):
    """The one-warp-per-pair forward at every bucket and at Q not a
    multiple of 32 (and T not a multiple of 16), with qlen 0, tlen 0,
    qlen = Q, tlen = T and lengths past them, in both configurations:
    equal to its plain version and, for int32, to the split kernel."""
    monkeypatch.setenv("RSB_SW16", "1" if acc == "int16" else "0")
    q_t, t_t, qlen, tlen = _codes(Q, T, 96, seed=Q + T, device=cuda)
    qlen[1], tlen[2], qlen[3], tlen[3], qlen[4], tlen[4] = 0, 0, Q, T, Q + 9, T + 2
    qlen[5], tlen[5] = 0, 0
    sw = SwParams(2, 8, 12, 1)
    dtype = sw_cuda.pick_dtype(Q, T, sw)
    assert dtype == (torch.int16 if acc == "int16" else torch.int32)
    valid = _valid(Q, T, qlen, tlen, cuda)
    got = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    _assert_forward_equal(got, sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, dtype), valid)
    assert [int(x[i]) for i in (1, 2, 5) for x in got[:3]] == [0, -1, 0] * 3
    if acc == "int32":
        split = sw_cuda.sw_forward_split(q_t, t_t, qlen, tlen, sw, 2)
        _assert_forward_equal(split, got, valid)


@pytest.mark.cuda
def test_int16_forward_at_the_span_bound(cuda, monkeypatch):
    """The largest match score pick_dtype admits to int16 at (40, 56), on
    pairs whose query is the target's prefix: scores near 2**14, equal to
    the plain int16 version and to the int32 kernel."""
    Q, T = 40, 56
    monkeypatch.setenv("RSB_SW16", "1")
    A = max(a for a in range(1, 2000)
            if sw_cuda.pick_dtype(Q, T, SwParams(a, 8, 12, 1)) == torch.int16)
    sw = SwParams(A, 8, 12, 1)
    q_t, t_t, qlen, tlen = _codes(Q, T, 64, seed=3, device=cuda)
    for b in range(0, 64, 4):
        q_t[:, b] = t_t[:Q, b]
        qlen[b] = tlen[b] = Q
    valid = _valid(Q, T, qlen, tlen, cuda)
    k16 = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    assert int(k16[0].max()) == A * Q > 16000
    _assert_forward_equal(k16, sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, torch.int16),
                          valid)
    monkeypatch.setenv("RSB_SW16", "0")
    _assert_forward_equal(k16, sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw), valid)


@pytest.mark.cuda
def test_forward_launch_refused_raises(cuda):
    """No silent failure: a target so long that a block's shared memory
    (4 warps x (ring + T target codes)) passes the card's limit is refused
    at launch and raises; a Q past MAX_Q raises before any launch."""
    sw = SwParams(2, 8, 12, 1)
    Q, T, B = 152, 60_000, 4
    q_t = torch.zeros((Q, B), dtype=torch.uint8, device=cuda)
    t_t = torch.zeros((T, B), dtype=torch.uint8, device=cuda)
    lens = torch.full((B,), 10, dtype=torch.int32, device=cuda)
    launches = sw_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        sw_cuda.sw_forward(q_t, t_t, lens, lens, sw)
    with pytest.raises(ValueError, match="Q <= 512"):
        sw_cuda.sw_forward(torch.zeros((513, B), dtype=torch.uint8, device=cuda), t_t[:64], lens,
                           lens, sw)
    assert sw_cuda.launches == launches
    torch.cuda.synchronize()  # nothing was left running
    ok = sw_cuda.sw_forward(q_t, t_t[:256], lens, lens, sw)  # the next launch runs
    assert ok[3].shape == (B, Q, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_kernel_matches_plain(cuda, seed):
    a = torch.from_numpy(probe.probe_input(seed)).to(cuda)
    launches = probe.launches
    got = probe.int16_probe(a)
    assert probe.launches == launches + 1
    assert torch.equal(got, probe.int16_probe_plain(a))


@pytest.mark.cuda
def test_probe_result_is_cached(cuda, monkeypatch, tmp_path):
    monkeypatch.setenv("RABBITSALIGN_TPU_TORCH_CACHE", str(tmp_path))
    launches = probe.launches
    assert probe.probe_int16_lowering(cuda) is True
    assert probe.probe_cache_path(cuda).parent == tmp_path
    assert probe.launches == launches + 1
    assert probe.probe_int16_lowering(cuda) is True  # from the cache
    assert probe.launches == launches + 1


@pytest.mark.cuda
def test_three_workers_match_one_on_cuda(cuda, tmp_path, capsys):
    """SE with the default 3 workers, each on its own CUDA stream, gives
    the bytes of one worker, and both launch the kernels; every extend
    batch of both went through the native enqueue (the log's Device extend
    line: `native_batches` equal to the batches dispatched)."""
    rng = np.random.RandomState(5)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000).tobytes()
    (tmp_path / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    reads = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(3000)]
    write_fastq(tmp_path / "se.fq", [revcomp(r) if i % 4 == 1 else r for i, r in enumerate(reads)],
                b"s")
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "se.fq"), "--chunk-size", "250",
            "--tpu-batch", "128", "--device", "cuda"]
    outs = []
    for threads in ("1", "3"):
        launches = sw_cuda.launches
        assert port_main([*argv, "-t", threads, "-o", str(tmp_path / f"t{threads}.sam")]) == 0
        assert sw_cuda.launches > launches
        log = capsys.readouterr().err
        extend = re.search(r"Device extend: \d+ jobs, \d+ DP cells in (\d+) batches "
                           r"\((\d+) native\)", log)
        assert extend and int(extend.group(2)) == int(extend.group(1)) > 3, log[-2000:]
        outs.append(b"".join(ln for ln in open(tmp_path / f"t{threads}.sam", "rb")
                             if not ln.startswith(b"@PG")))
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) > 3000


@pytest.fixture(scope="module")
def seed_world():
    """A 300 kbp genome with a tandem-repeat stretch, the port's index of
    it, and reads sampled from it behind the edge reads."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References

    rng = np.random.RandomState(9)
    genome = (rng.choice(np.frombuffer(b"ACGT", np.uint8), 250_000).tobytes() + b"ACGTTGCA" * 2000
              + rng.choice(np.frombuffer(b"ACGT", np.uint8), 34_000).tobytes())
    refs = References()
    refs.add("chr1", genome)
    index = StrobemerIndex(refs, IndexParameters.from_read_length(150))
    index.populate(0.0002)
    return genome, index


def _seed_args(params, M=256):
    sp, rp = params.syncmer, params.randstrobe
    return (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, M)


def _index_tensors(index, device):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int64).copy()).to(device)
            for a in (index.hashes, index.randstrobe_start_indices)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 4096])
@pytest.mark.parametrize("window", ["r150", "wide"])
def test_seed_kernels_match_plain_versions(cuda, seed_world, B, window):
    """Both seeding kernels against their plain versions on the card, byte
    for byte: the seeding kernel's counts, offsets, total and compacted
    strobes (the edge reads first, then reads of the genome; lengths -1
    for reads over 256), with nothing written past the chunk's strobes in
    its worst-case buffer; the lookup on those strobes, written into the
    buffer's positions, the smallest hash (unreachable: -1) and random
    misses."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters

    genome, index = seed_world
    params = (IndexParameters.from_read_length(150) if window == "r150" else
              IndexParameters.from_read_length(150, l=0, u=19, max_seed_len=255))
    edge = edge_reads(B)
    reads = (edge + sampled_reads(genome, B, seed=B))[:B]
    codes, lens = (torch.from_numpy(a).to(cuda) for a in code_batch(reads))
    args = _seed_args(params)
    M = args[-1]
    launches = seed_cuda.launches_seed
    buf, total = seed_cuda.seed_randstrobes(codes, lens, *args)
    assert seed_cuda.launches_seed == launches + 1
    want, want_total = seed_device.seed_strobes_plain(codes, lens, *args)
    assert total == want_total
    got_v, want_v = (seed_device.strobe_views(x, B, total) for x in (buf, want))
    for g, w in zip(got_v[:6], want_v[:6]):  # the positions are the lookup's
        assert g.dtype == w.dtype and torch.equal(g, w)
    counts = got_v[0]
    if B >= 33:
        assert (counts == -1).any() and (counts > 0).any()  # tie or long rows and others
    # no (B, 2M) slot: past the chunk's strobes the buffer keeps its fill
    filled = seed_cuda.seed_buffer(B, M, cuda).fill_(0xA5)
    seed_cuda.launch_seed_randstrobes(codes, lens, *args, filled)
    for g, w in zip(seed_device.strobe_views(filled, B, total)[:6], want_v[:6]):
        assert torch.equal(g, w)
    end = seed_device.strobe_bytes(B, total)
    assert bool((filled[end:seed_cuda._scratch_at(B, M)] == 0xA5).all())

    hashes, buckets = _index_tensors(index, cuda)
    rng = np.random.RandomState(B)
    misses = torch.from_numpy(rng.randint(-(1 << 63), (1 << 63) - 1, 64, dtype=np.int64))
    queries = torch.cat([got_v[2], hashes[:1], misses.to(cuda)])
    launches = seed_cuda.launches_find
    pos = seed_cuda.index_find(hashes, buckets, index.bits, queries)
    assert seed_cuda.launches_find == launches + 1
    assert torch.equal(pos, seed_device.index_find_device(hashes, buckets, index.bits, queries))
    assert int(pos[total]) == -1
    in_buf = seed_cuda.index_find(hashes, buckets, index.bits, got_v[2], out=got_v[6])
    assert in_buf.data_ptr() == got_v[6].data_ptr() and torch.equal(got_v[6], pos[:total])
    if window == "r150" and B > len(edge):  # most strobes of the genome's reads hit
        of_genome = int(counts[len(edge):].clamp(min=0).sum())
        assert int((pos[total - of_genome:total] >= 0).sum()) > of_genome // 2


@pytest.mark.cuda
def test_index_find_all_equal_index_on_cuda(cuda, seed_world):
    """An index whose hashes are all equal finds nothing, as the plain
    version; a (B, S) query batch keeps its shape."""
    _, index = seed_world
    h = np.full(9, index.hashes[1234], np.uint64)
    same = type(index)(index.references, index.parameters, index.bits)
    same.hashes = h
    same._build_buckets()
    hashes, buckets = _index_tensors(same, cuda)
    queries = np.array([[h[0], 0], [1, (1 << 64) - 1]], np.uint64)
    queries = torch.from_numpy(queries.view(np.int64)).to(cuda)
    got = seed_cuda.index_find(hashes, buckets, same.bits, queries)
    assert got.shape == (2, 2) and (got == -1).all()
    assert torch.equal(got, seed_device.index_find_device(hashes, buckets, same.bits, queries))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", ["1", "3"])
def test_device_seed_matches_host_seeding_on_cuda(cuda, tmp_path, threads, capsys):
    """The default run on the card seeds, looks up and walks the runs
    there: both seeding kernels launch and the run walk exactly once a
    chunk, besides the extend kernels, the engine walks only the tie and
    long reads on the host, and its SAM equals a host-seeded run's
    (`--device cpu`) and `--no-tpu`'s byte for byte. `--device-seed`
    names that default: the same launches, the same SAM."""
    from rabbitsalign_tpu_torch.ops import chain_cuda

    rng = np.random.RandomState(6)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000).tobytes()
    (tmp_path / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    reads = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(2000)]
    reads += edge_reads(1)
    write_fastq(tmp_path / "se.fq", [revcomp(r) if i % 4 == 1 else r for i, r in enumerate(reads)],
                b"s")
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "se.fq"), "--chunk-size", "250",
            "--tpu-batch", "128", "-t", threads]
    n_chunks = -(-len(reads) // 250)
    outs = {}
    for name, extra in (("card", ["--device", "cuda"]),
                        ("flag", ["--device", "cuda", "--device-seed"]),
                        ("host", ["--device", "cpu"]), ("no-tpu", ["--no-tpu"])):
        seeds, finds, fwd = seed_cuda.launches_seed, seed_cuda.launches_find, sw_cuda.launches
        walks = chain_cuda.launches_walk
        capsys.readouterr()
        assert port_main([*argv, *extra, "-o", str(tmp_path / "out.sam")]) == 0
        log = capsys.readouterr().err
        launched = (seed_cuda.launches_seed - seeds, seed_cuda.launches_find - finds)
        if name in ("host", "no-tpu"):
            assert launched == (0, 0) and sw_cuda.launches == fwd
            assert chain_cuda.launches_walk == walks
        else:
            assert sw_cuda.launches > fwd
            assert min(launched) >= 8  # a launch of each a chunk: 9 chunks of 250 reads
            assert chain_cuda.launches_walk - walks == n_chunks
            m = re.search(r"(\d+) tie or long reads seeded on the host, (\d+) reads' runs "
                          r"walked on the host", log)
            assert m, log[-3000:]
            assert int(m.group(1)) <= int(m.group(2)) <= int(m.group(1)) + 20
        outs[name] = b"".join(ln for ln in open(tmp_path / "out.sam", "rb")
                              if not ln.startswith(b"@PG"))
    assert outs["card"] == outs["host"]
    assert outs["flag"] == outs["host"]
    assert outs["no-tpu"] == outs["host"]
    assert len(outs["host"].splitlines()) > 2000


class _SentinelIndex:
    """Small runs, then a run of the 0xFF..F hash (the shards' padding
    value) at the top, long enough to leave trailing shards empty."""
    bits = 4
    filter_cutoff = 30

    def __init__(self):
        top = np.uint64(0xFFFFFFFFFFFFFFFF)
        self.hashes = np.concatenate([np.repeat(np.uint64(5), 2),
                                      np.repeat(np.uint64(1) << np.uint64(40), 3),
                                      np.repeat(top, 10)])
        n = self.hashes.shape[0]
        self.positions = np.arange(n, dtype=np.uint32)
        self.packed = (np.arange(n, dtype=np.uint32) << 8) | 1
        tops = (self.hashes >> np.uint64(64 - self.bits)).astype(np.int64)
        self.randstrobe_start_indices = np.searchsorted(
            tops, np.arange((1 << self.bits) + 1)).astype(np.uint64)


def _shard_keys(index, seed):
    rng = np.random.RandomState(seed)
    h = index.hashes
    picks = rng.randint(0, h.shape[0], 3000)
    return np.concatenate([h[picks], h[picks] + np.uint64(1), rng.randint(0, 2**63, 500).astype(
        np.uint64), np.array([0, 2**64 - 1, h[0], h[-1]], np.uint64)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("which", ["world", "sentinel", "runs"])
def test_find_runs_kernels_match_plain_versions(cuda, seed_world, n_shards, which):
    """The find_runs.cu kernels against their plain versions, exact: the
    wrappers on one shard's CUDA tensors against the plain functions on
    the same tensors (the gather at caps 3 and 40, dense, at the pod's
    `ends - width` and compacted with keys skipped by dst < 0; runs of 1,
    31, 32, 33 and over the cap rows), and a sharded index on cuda:0 (1
    or 4 shards of the one card) against the same index on the CPU: both
    dense lookups at the filter cutoff and at cap 2 (runs longer than the
    cap), and the compacted run records; with misses, the sentinel key and
    the smallest hash."""
    from rabbitsalign_tpu_torch.ops import shard_cuda, shard_find
    from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh

    index = {"world": lambda: seed_world[1], "sentinel": _SentinelIndex,
             "runs": RunsIndex}[which]()
    on_card = ShardedIndex(make_mesh(n_shards, "cuda"), index)
    on_cpu = ShardedIndex(make_mesh(n_shards, "cpu"), index)
    keys = _shard_keys(index, n_shards)
    launches = shard_cuda.launches_find_runs
    for cap in (on_card.filter_cutoff, 2):
        for lookup in ("find_runs", "find_runs_routed"):
            got, want = (getattr(si, lookup)(keys, cap) for si in (on_card, on_cpu))
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    got, want = on_card.find_runs_compact(keys), on_cpu.find_runs_compact(keys)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert shard_cuda.launches_find_runs > launches
    if which == "world":
        assert (got["count"] > 2).any() and (got["run_off"] >= 0).sum() > 1000
    elif which == "sentinel":
        res = on_card.find_runs_routed(np.array([2**64 - 1], np.uint64), 30)
        assert res["position"][0] == 5 and res["count"][0] == 10
    else:
        assert {1, 31, 32, 33, 57, 120} <= set(got["count"].tolist())

    h, p, k = on_card._shards[0]
    search = (on_card.shard_sizes[0], on_card.starts[0], on_card._buckets, on_card.bits)
    q = torch.from_numpy(keys.view(np.int64)).to(cuda)
    launches = shard_cuda.launches_find_runs
    gpos, count = shard_cuda.find_runs(h, *search, q)
    assert shard_cuda.launches_find_runs == launches + 1
    want = shard_find.find_runs_plain(h, *search, q)
    assert torch.equal(gpos, want[0]) and torch.equal(count, want[1])
    skip = torch.from_numpy(np.random.RandomState(n_shards).rand(q.numel()) < 0.3).to(cuda)
    for cap in (3, 40):
        width = count.clamp(max=cap)
        ends = torch.cumsum(width, 0)
        for dst in (None, ends - width, torch.where(skip, -1, ends - width)):
            rows = q.numel() * cap if dst is None else max(int(ends[-1]), 1)
            outs = [torch.zeros(rows, dtype=torch.int32, device=cuda) for _ in range(4)]
            shard_cuda.gather_runs(p, k, gpos, count, on_card.starts[0], cap, dst, *outs[:2])
            shard_find.gather_runs_plain(p, k, gpos, count, on_card.starts[0], cap, dst,
                                         *outs[2:])
            assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert shard_cuda.launches_find_runs == launches + 7


@pytest.mark.cuda
@pytest.mark.parametrize("threads", ["1", "3"])
def test_shard_index_matches_default_on_cuda(cuda, tmp_path, threads):
    """--shard-index on the card: the SAM equals the default run's, and
    the lookup kernels launched only with the flag."""
    from rabbitsalign_tpu_torch.ops import shard_cuda

    rng = np.random.RandomState(7)
    unit = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300).tobytes()
    genome = (rng.choice(np.frombuffer(b"ACGT", np.uint8), 150_000).tobytes() + unit * 80
              + rng.choice(np.frombuffer(b"ACGT", np.uint8), 50_000).tobytes())
    (tmp_path / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    reads = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(2000)]
    write_fastq(tmp_path / "se.fq", [revcomp(r) if i % 4 == 1 else r for i, r in enumerate(reads)],
                b"s")
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "se.fq"), "--chunk-size", "250",
            "--tpu-batch", "128", "--device", "cuda", "-t", threads]
    outs = []
    for extra in ([], ["--shard-index"]):
        finds, fwd = shard_cuda.launches_find_runs, sw_cuda.launches
        assert port_main([*argv, *extra, "-o", str(tmp_path / "out.sam")]) == 0
        assert sw_cuda.launches > fwd
        launched = shard_cuda.launches_find_runs - finds
        assert launched >= 16 if extra else launched == 0  # 8 chunks, 2 launches each
        outs.append(b"".join(ln for ln in open(tmp_path / "out.sam", "rb")
                             if not ln.startswith(b"@PG")))
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) > 2000


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 3])
@pytest.mark.parametrize("which", ["world", "sentinel"])
def test_pod_index_on_cuda_matches_cpu(cuda, seed_world, hosts, which):
    """PodShardedIndex with every host's slice on the card (its own
    lookups and, from the server threads on streams of their own, the
    other hosts' keys) against the same pod on the CPU (the plain
    versions): `find_runs_compact` and `find_runs_routed` equal at caps 1,
    the filter cutoff and 1000, and the lookup kernels launched."""
    from rabbitsalign_tpu_torch.ops import shard_cuda
    from rabbitsalign_tpu_torch.parallel.multihost import PodShardedIndex

    index = seed_world[1] if which == "world" else _SentinelIndex()
    pods = []
    for device in ("cuda", "cpu"):
        peers = [f"127.0.0.1:{p}" for p in _free_ports(hosts)]
        pods.append([PodShardedIndex(index, p, hosts, peers, device) for p in range(hosts)])
    try:
        keys = _shard_keys(index, hosts)
        launches = shard_cuda.launches_find_runs
        for on_card, on_cpu in zip(*pods):
            for cap in (1, on_card.filter_cutoff, 1000):
                for lookup in ("find_runs_compact", "find_runs_routed"):
                    got, want = (getattr(pod, lookup)(keys, cap) for pod in (on_card, on_cpu))
                    for k in want:
                        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            assert on_card.stats["remote_keys"] > 0
        assert shard_cuda.launches_find_runs > launches
    finally:
        for pod in pods[0] + pods[1]:
            pod.close()


@pytest.mark.cuda
def test_pod_cli_on_cuda_matches_single_host(cuda, tmp_path):
    """Two `--num-nodes 2 --pod-index-peers` processes on the one card
    (python -m, the repository root on PYTHONPATH): the merged SAM equals
    a single-host `-t 1` run's apart from @PG, and each host launched the
    forward, the traceback and find_runs (its -v log)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    rng = np.random.RandomState(17)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000).tobytes()
    (tmp_path / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    reads = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(3000)]
    write_fastq(tmp_path / "se.fq", [revcomp(r) if i % 4 == 1 else r for i, r in enumerate(reads)],
                b"s")
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "se.fq"), "--chunk-size", "500",
            "--tpu-batch", "128", "--device", "cuda"]
    assert port_main([*argv, "-t", "1", "-o", str(tmp_path / "single.sam")]) == 0
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    coord, *peers = _free_ports(3)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rabbitsalign_tpu_torch.cli", *argv, "-v", "-o",
         str(tmp_path / "pod.sam"), "--num-nodes", "2", "--node-id", str(node), "--coordinator",
         f"127.0.0.1:{coord}", "--pod-index-peers", ",".join(f"127.0.0.1:{p}" for p in peers)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=tmp_path, env=env) for node in (0, 1)]
    for node, p in enumerate(procs):
        _, err = p.communicate(timeout=600)
        err = err.decode()
        assert p.returncode == 0, err[-3000:]
        launches = json.loads(err.split(f"Host {node}/2 kernel launches: ")[1].splitlines()[0])
        assert all(launches[k] > 0 for k in ("sw_forward", "sw_traceback", "find_runs")), launches
        assert "feed misses 0" in err
    want, got = ([ln for ln in open(tmp_path / f, "rb") if not ln.startswith(b"@PG")]
                 for f in ("single.sam", "pod.sam"))
    assert got == want and len(got) > 3000


@pytest.fixture(scope="module")
def multi_world(tmp_path_factory):
    """A 200 kbp genome with a repeat block, its index, 2000 SE reads and
    600 PE pairs as FASTQ."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References

    d = tmp_path_factory.mktemp("multicard")
    rng = np.random.RandomState(23)
    unit = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300).tobytes()
    genome = (rng.choice(np.frombuffer(b"ACGT", np.uint8), 150_000).tobytes() + unit * 80
              + rng.choice(np.frombuffer(b"ACGT", np.uint8), 26_000).tobytes())
    (d / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    reads = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(2000)]
    write_fastq(d / "se.fq", [revcomp(r) if i % 4 == 1 else r for i, r in enumerate(reads)], b"s")
    r1, r2 = [], []
    for _ in range(600):
        st = rng.randint(len(genome) - 1000)
        r1.append(sim_read(genome, st, rng))
        r2.append(revcomp(sim_read(genome, st + 300 - READ_LEN, rng)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")
    refs = References.from_fasta(str(d / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(150))
    index.populate(0.0002)
    return d, refs, index


def _multi_run(multi_world, pe, monkeypatch, **kw):
    """(SAM bytes, the workers' pipelines, genome uploads, the current
    stream of each extend) of a deterministic 3-worker run."""
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.map.common import MappingParameters
    from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

    d, refs, index = multi_world
    uploads, enqueued = [], []
    real_upload, real_enqueue = pnp.resident_ref_codes, pnp.extend_q2_enqueue

    def counting(codes, device):
        uploads.append(device)
        return real_upload(codes, device)

    def enqueue(q2, ref_codes, Q, T, params):
        enqueued.append((threading.get_ident(), ref_codes,
                         torch.cuda.current_stream(ref_codes.device)))
        return real_enqueue(q2, ref_codes, Q, T, params)

    monkeypatch.setattr(pnp, "resident_ref_codes", counting)
    monkeypatch.setattr(pnp, "extend_q2_enqueue", enqueue)
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff)
    pipe = pnp.ThreadedNativePipeline(index, index.parameters, refs, AlignmentParameters(), mp,
                                      batch_size=128, n_workers=3, deterministic=True, **kw)
    made, mk = [], pipe._mk
    pipe._mk = lambda: made.append(mk()) or made[-1]
    files = (str(d / "r1.fq"), str(d / "r2.fq")) if pe else (str(d / "se.fq"), "")
    out = []
    pipe.map_file(*files, False, 100, out.append)
    monkeypatch.undo()
    return b"".join(out), made, uploads, enqueued


def _check_multi_entry(cuda, multi_world, monkeypatch, devices):
    """3 workers over `devices` against the plain CPU run, SE and PE: equal
    bytes; the genome uploaded once a distinct card; each worker's batches
    split over the entries in turn, every one through the native enqueue
    against its entry's genome on the worker's stream of that card (one
    stream of its own a card, not the card's default stream); and, with
    --shard-index, the same SAM."""
    cards = list(dict.fromkeys(devices))
    for pe in (False, True):
        want, *_ = _multi_run(multi_world, pe, monkeypatch, device="cpu")
        launches = sw_cuda.launches
        got, pipes, uploads, enqueued = _multi_run(multi_world, pe, monkeypatch, devices=devices)
        assert got == want and len(got.splitlines()) == (1200 if pe else 2000)
        assert sw_cuda.launches > launches
        assert sorted(map(str, uploads)) == sorted(map(str, cards))
        assert len(pipes) == 3
        for pipe in pipes:
            n = sum(pipe.dispatched)
            assert pipe.dispatched == [len(range(k, n, len(devices))) for k in range(len(devices))]
            assert pipe.counters()["native_batches"] == n
            assert list(pipe.streams) == cards
            for card, stream in pipe.streams.items():
                assert stream != torch.cuda.default_stream(card)
        # a worker's batch i: entry i % n's genome, on the worker's stream of its card
        genomes = pipes[0].run._genomes
        assert len(enqueued) == sum(sum(p.dispatched) for p in pipes)
        by_thread = {}
        for tid, ref, stream in enqueued:
            by_thread.setdefault(tid, []).append((ref, stream))
        assert sorted(map(len, by_thread.values())) == sorted(sum(p.dispatched) for p in pipes)
        for batches in by_thread.values():
            for i, (ref, stream) in enumerate(batches):
                entry = devices[i % len(devices)]
                assert ref is genomes[entry] and stream.device == entry
        mine = {s for p in pipes for s in p.streams.values()}
        assert len(mine) == 3 * len(cards) and {s for *_, s in enqueued} <= mine
        assert sum(sum(p.dispatched) for p in pipes) >= 2 * len(devices)
        shard, *_ = _multi_run(multi_world, pe, monkeypatch, devices=devices, shard_index=True)
        assert shard == want


def _check_sharded_entries(multi_world, devices):
    """A ShardedIndex over `devices` against the same cut on the CPU: both
    dense lookups and the compacted run records, exact."""
    from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh

    index = multi_world[2]
    on_card = ShardedIndex(devices, index)
    on_cpu = ShardedIndex(make_mesh(len(devices), "cpu"), index)
    assert [t.device for t, _, _ in on_card._shards] == devices
    keys = _shard_keys(index, len(devices))
    for cap in (on_card.filter_cutoff, 2):
        for lookup in ("find_runs", "find_runs_routed", "find_runs_compact"):
            got, want = (getattr(si, lookup)(keys, cap) for si in (on_card, on_cpu))
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.cuda
def test_two_entries_of_one_card_match_the_cpu(cuda, multi_world, monkeypatch):
    """The device list [cuda:0, cuda:0]: the round-robin, the genome cache,
    the workers' streams and --shard-index over two entries of the one
    card, against the plain CPU run; and the sharded index's lookups over
    those two entries against the CPU's."""
    devices = [torch.device("cuda", 0)] * 2
    _check_multi_entry(cuda, multi_world, monkeypatch, devices)
    _check_sharded_entries(multi_world, devices)


@pytest.mark.cuda
def test_every_card_matches_the_cpu(cuda, multi_world, monkeypatch):
    """Every card of the host (`local_devices`): the same checks over real
    cards, the shards merged across cards; and the per-card state of the
    kernels (index_find's wave, the forward's shared-memory attribute) on
    each card against the plain versions."""
    from rabbitsalign_tpu_torch.parallel.sharding import local_devices

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: one card runs only the two-entry test above")
    cards = local_devices("cuda")
    _check_multi_entry(cuda, multi_world, monkeypatch, cards)
    _check_sharded_entries(multi_world, cards)
    index = multi_world[2]
    Q, T = max((q, t) for q, t, _, _ in engine_buckets(150))
    buf, genome = q2_batch(mixed_pairs(Q, T, 70, seed=3), Q, seed=3)
    for card in reversed(cards):
        q_t, t_t, qlen, tlen = px.unpack_q2(torch.from_numpy(buf).to(card),
                                            px.resident_ref_codes(genome, card), Q, T)
        got = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, SwParams(2, 8, 12, 1))
        want = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, SwParams(2, 8, 12, 1))
        for k, p in zip(got[:3], want[:3]):
            assert torch.equal(k, p)
        hashes, buckets = _index_tensors(index, card)
        queries = hashes[::7].contiguous()
        assert torch.equal(seed_cuda.index_find(hashes, buckets, index.bits, queries),
                           seed_device.index_find_device(hashes, buckets, index.bits, queries))


@pytest.fixture(scope="module")
def chain_world():
    """tests/test_chain_device.py's two contigs and a third whose 300 bp
    unit repeated 80 times gives runs of 80 rows; the port's index; reads
    of that file's two sets, sampled reads of the repeat contig and
    tandem repeats of 3 to 25 bp units (tie rows)."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References

    genome = world_genome()
    rep = random_dna(5000, seed=60) + random_dna(300, seed=61) * 80 + random_dna(5000, seed=62)
    refs = References()
    refs.add("cA", genome[:45000].encode())
    refs.add("cB", genome[45000:].encode())
    refs.add("cC", rep.encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    reads = (composed_reads(genome) + chain_reads(genome) + sampled_reads(rep.encode(), 40, 63)
             + [(random_dna(u, seed=u) * 60)[:150].encode() for u in (3, 5, 8, 13, 25)])
    return index, params, reads


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 4096])
def test_syncmers_scan_kernel_matches_plain(cuda, chain_world, B):
    """The exact scan's positions, hashes and counts on the card equal
    `syncmers_scan_plain` on the same tensors, tie-heavy reads (tandem
    repeats, homopolymers, N runs) among them, at the default (k, s, t)
    and four others (w = 32 and w = 1 among them), and (B = 33) on reads
    of up to 1500 bases at L = 1600 (three of the kernel's segments);
    and (B > 1) the syncmers of `randstrobes_query_device` give every
    read's host strobes, tie rows included."""
    from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

    index, params, reads = chain_world
    reads = ((edge_reads(B) + tie_reads(64, seed=B) + reads) * (B // len(reads) + 2))[:B]
    codes, lens = (torch.from_numpy(a).to(cuda) for a in code_batch(reads))
    sp = params.syncmer
    launches = seed_cuda.launches_syncmers
    got = seed_cuda.syncmers_scan(codes, lens, sp.k, sp.s, sp.t_syncmer, 256)
    assert seed_cuda.launches_syncmers == launches + 1
    want = seed_device.syncmers_scan_plain(codes, lens, sp.k, sp.s, sp.t_syncmer, 256)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for k, s, t in ((15, 9, 4), (24, 12, 7), (32, 1, 16), (9, 9, 1)):
        got = seed_cuda.syncmers_scan(codes, lens, k, s, t, 256)
        want = seed_device.syncmers_scan_plain(codes, lens, k, s, t, 256)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (k, s, t)
    if B == 33:
        long_codes, long_lens = (torch.from_numpy(a).to(cuda)
                                 for a in code_batch(long_scan_reads(), L=1600))
        for k, s, t, M in ((sp.k, sp.s, sp.t_syncmer, 1600), (sp.k, sp.s, sp.t_syncmer, 64),
                           (32, 1, 16, 1600)):
            got = seed_cuda.syncmers_scan(long_codes, long_lens, k, s, t, M)
            want = seed_device.syncmers_scan_plain(long_codes, long_lens, k, s, t, M)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (k, s, t, M)
    if B == 1:
        return
    args = _seed_args(params)
    h, st, en, _, nf, nr = (x.cpu().numpy() for x in seed_device.randstrobes_query_device(
        codes, lens.clamp(min=0), *args))
    for i, read in enumerate(reads[:200]):
        host = randstrobes_query(read, params) if len(read) <= 256 else None
        rows = list(range(nf[i])) + list(range(256, 256 + nr[i]))
        assert h[i, rows].view(np.uint64).tolist() == ([] if host is None else host.hash.tolist())
        if host is not None:
            assert st[i, rows].tolist() == host.start.tolist()


def _dirty_cache(shapes):
    """Tensors of these (shape, dtype) filled with 0xFF bytes and freed, so
    that the caching allocator hands their blocks to the next allocations
    of those sizes: a kernel that leaves an element unwritten shows."""
    junk = [torch.full(shape, -1, dtype=torch.int32 if dt == torch.int32 else torch.uint8,
                       device="cuda") for shape, dt in shapes]
    del junk


def _merge_streams(which):
    if which.startswith("mixed"):
        return mixed_merge_streams(seed=int(which[5:]))
    return {"synthetic": synthetic_streams, "wide": wide_streams,
            "edge": merge_edge_streams}[which]()


@pytest.mark.cuda
@pytest.mark.parametrize("which,cap", [("synthetic", 32), ("synthetic", 4), ("wide", 128),
                                       ("wide", 72), ("wide", 40), ("wide", 129), ("wide", 200),
                                       ("edge", 200), ("edge", 129), ("edge", 65), ("edge", 33),
                                       ("edge", 32), ("edge", 8), ("edge", 3), ("mixed0", 32),
                                       ("mixed1", 33), ("mixed3", 100), ("mixed5", 200)])
def test_merge_kernel_matches_plain(cuda, which, cap):
    """The merge's emissions (zeros past each count), counts and overflow
    flags on the card equal `merge_hits_plain`: on the lane's path and at
    two and four slot groups of the warp's, on the boundary cases of
    `merge_edge_streams` (the lane's table of 32 slots full and one past
    it, sweeps and segment flushes on each path, empty streams, more than
    128 NAMs open), on warps that mix lane and warp streams
    (`mixed_merge_streams`), tables that overflow included, and at caps
    past 128 (129 and 200), as the JAX function takes them. The outputs' memory is dirtied first, and
    the call is one kernel launch and no other work on the card."""
    from rabbitsalign_tpu_torch.ops import chain_cuda
    from rabbitsalign_tpu_torch.ops.chain_device import merge_hits_plain

    args = [x.to(cuda) for x in stream_tensors(_merge_streams(which))]
    N, S = args[0].shape[0], args[2].numel() - 1
    chain_cuda.merge_hits(*args, 20, cap)  # built and warm, outside the profile
    launches = chain_cuda.launches_merge
    for calls in range(1, 4):  # a capture with no event at all (CUPTI now and then) is retaken
        torch.cuda.synchronize()
        _dirty_cache([((N, 7), torch.int32), ((S,), torch.int32), ((S,), torch.bool),
                      ((N, 7), torch.int32)])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = chain_cuda.merge_hits(*args, 20, cap)
            torch.cuda.synchronize()
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
    assert chain_cuda.launches_merge == launches + calls
    assert len(on_card) == 1 and "merge_hits_kernel" in on_card[0], on_card
    want = merge_hits_plain(*args, 20, cap)
    assert int(got[2].view(torch.uint8).max()) <= 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[2].any()) == (cap in (4, 72, 40) or
                                   ((which == "edge" or which.startswith("mixed")) and cap != 200))


@pytest.mark.cuda
def test_merge_kernel_takes_strided_inputs(cuda):
    """Hits, seg and offsets given as strided views on the card give the
    same outputs as their contiguous copies, with one merge launch."""
    from rabbitsalign_tpu_torch.ops import chain_cuda
    from rabbitsalign_tpu_torch.ops.chain_device import merge_hits_plain

    hits, seg, offsets = (x.to(cuda) for x in stream_tensors(merge_edge_streams()))
    views = (hits.t().contiguous().t(), torch.stack([seg, seg], 1)[:, 0],
             torch.stack([offsets, offsets], 1)[:, 1])
    assert not any(v.is_contiguous() for v in views)
    launches = chain_cuda.launches_merge
    got = chain_cuda.merge_hits(*views, 20, 200)
    assert chain_cuda.launches_merge == launches + 1
    for g, w in zip(got, merge_hits_plain(hits, seg, offsets, 20, 200)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cutoff,maxh,cap", [(None, 192, None), (1000, 4000, 100), (3, 40, 3),
                                             ("mixed", 4000, 100), ("mixed", 60, 40),
                                             ("mixed", 600, 33)],
                         ids=["filter-cutoff", "all-kept", "filtered-overflow", "mixed-runs",
                              "mixed-runs-overflow", "mixed-runs-filtered"])
def test_walk_kernel_matches_plain(cuda, chain_world, cutoff, maxh, cap):
    """The run walk's hits, n_hits, total, good and overflow on the card
    equal `walk_hits_plain`, on runs of 80 rows (three rounds of 32), with
    the filter at the index's cutoff, lifted, and at 3; and on the
    synthetic index of `mixed_runs` (rounds that mix runs of 1, 2, 3, 4,
    5, 33 and 80 rows, tie rows among the reads) with the filter lifted
    (maxh 4000, and 60 with runs cut at 40 rows) and at 33."""
    from rabbitsalign_tpu_torch.ops import chain_cuda, front_device

    if cutoff == "mixed":
        args = tuple(x.to(cuda) for x in mixed_runs()[0])
        cutoff = 1000 if cap != 33 else 33
        launches = chain_cuda.launches_walk
        got = chain_cuda.walk_hits(*args, 20, cutoff, maxh, cap)
        assert chain_cuda.launches_walk == launches + 1
        want = front_device.walk_hits_plain(*args, 20, cutoff, maxh, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert bool(want[4].any()) == (maxh == 60)
        return
    index, params, reads = chain_world
    codes, lens = (torch.from_numpy(a).to(cuda) for a in code_batch(reads))
    buf, total = seed_cuda.seed_randstrobes(codes, lens, *_seed_args(params))
    views = seed_device.strobe_views(buf, len(reads), total)
    dev_index = front_device.upload_index_split(index, cuda)
    seed_cuda.index_find(dev_index[7], dev_index[4], index.bits, views[2], out=views[6])
    cutoff = index.filter_cutoff if cutoff is None else cutoff
    cap = cutoff if cap is None else cap
    planes = (dev_index[7], dev_index[2], dev_index[3])
    launches = chain_cuda.launches_walk
    got = chain_cuda.walk_hits(*views[:7], *planes, params.syncmer.k, cutoff, maxh, cap)
    assert chain_cuda.launches_walk == launches + 1
    want = front_device.walk_hits_plain(*views[:7], *planes, params.syncmer.k, cutoff, maxh, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(want[1].sum()) > len(reads)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["filter-cutoff", "mixed-runs", "mixed-runs-filtered"])
def test_walk_kernel_compact_layout_matches_plain(cuda, chain_world, case):
    """`walk_hits_compact` on the card, one launch, the layout the main
    path copies back (each read's hits at its strobe offset, at most its
    strobe count of them): its views equal `walk_hits_compact_plain`'s,
    on the seeded reads of the 80-row repeat at the index's cutoff (the
    repeat's reads overflow their room) and on `mixed_runs` with the
    filter lifted and at 33."""
    from rabbitsalign_tpu_torch.ops import chain_cuda, front_device

    if case == "filter-cutoff":
        index, params, reads = chain_world
        codes, lens = (torch.from_numpy(a).to(cuda) for a in code_batch(reads))
        buf, total = seed_cuda.seed_randstrobes(codes, lens, *_seed_args(params))
        views = seed_device.strobe_views(buf, len(reads), total)
        dev_index = front_device.upload_index_split(index, cuda)
        seed_cuda.index_find(dev_index[7], dev_index[4], index.bits, views[2], out=views[6])
        args = (*views, dev_index[7], dev_index[2], dev_index[3])
        k, cutoff = params.syncmer.k, index.filter_cutoff
    else:
        args, k = tuple(x.to(cuda) for x in mixed_runs()[0]), 20
        cutoff = 1000 if case == "mixed-runs" else 33
    cap = min(cutoff, 100)
    launches = chain_cuda.launches_walk
    got = chain_cuda.walk_hits_compact(*args, k, cutoff, cap)
    assert chain_cuda.launches_walk == launches + 1
    want = front_device.walk_hits_compact_plain(*args, k, cutoff, cap)
    N, T = args[0].numel(), args[2].numel()
    assert got.shape == want.shape == (front_device.walk_words(N, T),)
    views = [front_device.walk_views(x, N, T) for x in (got, want)]
    for g, w in zip(*views):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(views[1][4].any()) and int(views[1][1].sum()) > N


@pytest.mark.cuda
def test_device_nam_front_end_matches_the_cpu(cuda, chain_world):
    """find_nams_composed_batch on the card: the same None pattern and the
    same NAMs as on the CPU and, where not None, as the host find_nams;
    it launches the seeding, lookup, walk and merge kernels once each.
    find_nams_device_chain on the card equals the host find_nams."""
    from rabbitsalign_tpu_torch.chain.nams import find_nams
    from rabbitsalign_tpu_torch.ops import chain_cuda
    from rabbitsalign_tpu_torch.ops.chain_device import find_nams_device_chain
    from rabbitsalign_tpu_torch.ops.front_device import (find_nams_composed_batch,
                                                         upload_index_split)
    from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query

    index, params, reads = chain_world
    before = (seed_cuda.launches_seed, seed_cuda.launches_find, chain_cuda.launches_walk,
              chain_cuda.launches_merge)
    got = find_nams_composed_batch(reads, upload_index_split(index, cuda), params,
                                   index.filter_cutoff)
    after = (seed_cuda.launches_seed, seed_cuda.launches_find, chain_cuda.launches_walk,
             chain_cuda.launches_merge)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    want = find_nams_composed_batch(reads, upload_index_split(index, "cpu"), params,
                                    index.filter_cutoff)
    assert [g is None for g in got] == [w is None for w in want]
    checked = 0
    for read, g, w in zip(reads, got, want):
        if g is None:
            continue
        host = find_nams(randstrobes_query(read, params), index)
        assert g[0] == w[0] == host[0]
        assert [nam_key(n) for n in g[1]] == [nam_key(n) for n in w[1]] \
            == [nam_key(n) for n in host[1]]
        checked += 1
    assert checked > len(reads) // 2
    for read in reads[:40]:
        qrs = randstrobes_query(read, params)
        f, nams = find_nams_device_chain(qrs, index, device=cuda)
        host = find_nams(qrs, index)
        assert f == host[0] and [nam_key(n) for n in nams] == [nam_key(n) for n in host[1]]


# -- the Python mapper's extend layout and BatchAligner ----------------------

def _packed_inputs(Q, T, B, seed, device):
    from .torch_extend_cases import bucket_arrays

    pairs = (mixed_pairs(Q, T, max(B, 7), seed=seed) + gap_pairs(Q, T, seed))[:B]
    return torch.from_numpy(px.pack_input(*bucket_arrays(pairs, Q, T))).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", [(256, 512), (256, 1536), (512, 2048), (200, 1000)])
@pytest.mark.parametrize("B", [1, 33, 512])
def test_extend_batch_packed_matches_plain(cuda, Q, T, B):
    """extend_batch_packed on the card (forward kernel, then the traceback
    kernel's packed epilogue) against the plain forward and packed walk
    on the same card tensors, at the BatchAligner's three buckets and at
    a T that is not a multiple of 16, on mixed pairs."""
    from rabbitsalign_tpu_torch.ops.batch_extend import DEFAULT_BUCKETS

    assert {(q, t) for q, t, _ in DEFAULT_BUCKETS} <= {(256, 512), (256, 1536), (512, 2048)}
    sw = SwParams(2, 8, 12, 1)
    buf = _packed_inputs(Q, T, B, seed=Q + B, device=cuda)
    launches = (sw_cuda.launches, tb_cuda.launches, px.packed_calls)
    got = px.extend_batch_packed(buf, Q, T, sw)
    assert (sw_cuda.launches, tb_cuda.launches, px.packed_calls) == \
        (launches[0] + 1, launches[1] + 1, launches[2] + 1)
    lens = buf[Q + T:].to(torch.int32)
    fwd = sw_cuda.sw_forward_plain(buf[:Q], buf[Q:Q + T], lens[0] | (lens[1] << 8),
                                   lens[2] | (lens[3] << 8), sw, torch.int32)
    want = tb_cuda.sw_traceback_packed_plain(fwd[3], *fwd[:3])
    assert got.device.type == "cuda" and torch.equal(got, want)


def _info(a):
    return (list(a.cigar.ops), a.edit_distance, a.ref_start, a.ref_end, a.query_start,
            a.query_end, a.sw_score)


def _batch_results(aligner_, jobs):
    for q, r in jobs:
        aligner_.submit(q, r)
    return [_info(a) for a in aligner_.flush()]


@pytest.fixture(scope="module")
def batch_world():
    from .torch_extend_cases import batch_jobs

    rng = np.random.RandomState(99)
    genome = "".join(rng.choice(list("ACGT"), 300_000))
    return batch_jobs(genome) + batch_jobs(genome, seed=4)


@pytest.mark.cuda
def test_batch_aligner_on_cuda_matches_cpu_and_host(cuda, batch_world):
    """BatchAligner("cuda") at the default buckets against
    BatchAligner("cpu") (the plain versions) and the HostBatchAligner on
    simulated jobs, with two dispatches in flight before either is
    collected."""
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.ops.batch_extend import BatchAligner, HostBatchAligner

    ap = AlignmentParameters()
    card = BatchAligner(ap, 32, device=cuda)
    half = len(batch_world) // 2
    tokens = []
    for part in (batch_world[:half], batch_world[half:]):
        for q, r in part:
            card.submit(q, r)
        tokens.append(card.dispatch())
    got = [_info(a) for t in tokens for a in card.collect(t)]
    cpu = BatchAligner(ap, 32, device="cpu")
    assert got == _batch_results(cpu, batch_world)
    assert got == _batch_results(HostBatchAligner(ap), batch_world)
    assert (card.n_device_jobs, card.n_fallbacks, card.n_host_jobs) == \
        (cpu.n_device_jobs, cpu.n_fallbacks, cpu.n_host_jobs)
    assert card.n_device_jobs > 30 and card.n_fallbacks >= 1


@pytest.mark.cuda
def test_batch_aligner_on_cuda_runs_no_plain_version(cuda, batch_world, monkeypatch):
    """The same jobs with every plain version of the forward, the walk and
    the pack made to raise: the card launches its kernels or fails."""
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.ops.batch_extend import BatchAligner

    ap = AlignmentParameters()
    want = _batch_results(BatchAligner(ap, 32, device="cpu"), batch_world)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((sw_cuda, "sw_forward_plain"), (px, "_pack_rle_output"),
                      (tb_cuda, "pack_rle_output"), (tb_cuda, "sw_traceback_plain"),
                      (tb_cuda, "sw_traceback_packed_plain")):
        monkeypatch.setattr(mod, name, refuse)
    launches = (sw_cuda.launches, tb_cuda.launches)
    assert _batch_results(BatchAligner(ap, 32, device=cuda), batch_world) == want
    assert sw_cuda.launches > launches[0] and tb_cuda.launches > launches[1]


@pytest.mark.cuda
@pytest.mark.parametrize("sw16", ["0", "1"], ids=["int32", "int16"])
def test_pe250_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch, capsys, sw16):
    """2x250 pairs under the 250 profile the CLI estimates for them, at the
    default 3 workers: the run on the card (both seeding kernels, the
    (256, 360) extend at R = 8 in batches of 512, the forward in int32 or,
    under RSB_SW16, int16) writes the SAM of the same run on the CPU (host
    seeding, the extend's plain versions), and every planned job is in the
    tight bucket."""
    monkeypatch.setenv("RSB_SW16", sw16)
    assert sw_cuda.pick_dtype(256, 360, SwParams(2, 8, 12, 1)) == (
        torch.int16 if sw16 == "1" else torch.int32)
    write_pe250(tmp_path, seed=251, n_pairs=3000)
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
            "--chunk-size", "1000", "-v"]
    seeds, fwd, fwd16, tb = (seed_cuda.launches_seed, sw_cuda.launches, sw_cuda.launches_i16,
                             tb_cuda.launches)
    assert port_main(argv + ["-o", str(tmp_path / "card.sam")]) == 0
    log = capsys.readouterr().err
    assert "Estimated read length: 250 bp" in log
    assert seed_cuda.launches_seed >= seeds + 3  # a launch a chunk: 3 chunks of 1000 pairs
    assert tb_cuda.launches > tb
    assert (sw_cuda.launches_i16 > fwd16) if sw16 == "1" else (sw_cuda.launches > fwd)
    extend = re.search(r"Device extend: (\d+) jobs, \d+ DP cells in (\d+) batches.*; (\d+) "
                       r"planned, (\d+) in the tight bucket", log)
    assert extend, log[-3000:]
    jobs, batches, planned, tight = map(int, extend.groups())
    assert tight == planned >= jobs > 1000 and batches >= 3
    assert port_main(argv + ["--device", "cpu", "-o", str(tmp_path / "cpu.sam")]) == 0
    sams = [b"".join(ln for ln in open(tmp_path / f"{name}.sam", "rb")
                     if not ln.startswith(b"@PG")) for name in ("card", "cpu")]
    assert sams[0] == sams[1]
    assert len(sams[0].splitlines()) >= 6000
