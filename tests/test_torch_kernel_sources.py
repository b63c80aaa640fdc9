"""The sources of the forward (csrc/sw_forward.cu: the production int32 and
int16 kernels, one warp a pair, and the split kernels, 2 and 4 pairs a
warp) and of the index lookup (csrc/index_find.cu), run on the CPU by the
thread-a-lane emulation of tests/torch_cuda_emu.h, against their plain
PyTorch versions and the JAX package's lookup; and the emulation's shims
of Hopper's DPX instructions against their definitions in the CUDA Math
API. Everything is integer and made from a seed: every comparison is
exact."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.ops import seed_device as jsd
from rabbitsalign_tpu_torch.ops import cuda_build, sw_cuda
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import seed_device as psd

from . import torch_cuda_emu
from .test_sharded_index import _repetitive_world
from .test_torch_sharded_index import _random_stub, _sentinel_stub
from .torch_extend_cases import mixed_pairs, q2_batch, q2_edge_batch

SW = sw_cuda.SwParams(2, 8, 12, 1)
# a gap extension of 0: an extension ties with the opening it follows
FLAT = sw_cuda.SwParams(1, 1, 2, 0)
WIDE = 8  # a bucket wider than this takes the binary search four steps or more

DPX_SOURCE = """
#include <cuda_runtime.h>
extern "C" void dpx(const int* a, const int* b, const int* c, int n, int* out) {
    for (int i = 0; i < n; ++i) {
        out[5 * i] = __viaddmax_s32(a[i], b[i], c[i]);
        out[5 * i + 1] = __viaddmax_s32_relu(a[i], b[i], c[i]);
        out[5 * i + 2] = __vimax3_s32(a[i], b[i], c[i]);
        out[5 * i + 3] = __vimax3_s32_relu(a[i], b[i], c[i]);
        out[5 * i + 4] = __vimax_s32_relu(a[i], b[i]);
    }
}
"""


def test_dpx_shims_match_their_definitions(tmp_path):
    """__viaddmax_s32(a, b, c) = max(a + b, c), its _relu form max(.., 0),
    __vimax3_s32(a, b, c) = max(a, b, c), its _relu form, and
    __vimax_s32_relu(a, b) = max(a, b, 0), the sums wrapping in 32 bits:
    on random values, the int32 extremes and the values the forward
    passes (NEG = -2**28, NEG16 = -2**14)."""
    lib = torch_cuda_emu.build_source("dpx", DPX_SOURCE, tmp_path)
    rng = np.random.RandomState(4)
    edge = np.array([0, 1, -1, 2**31 - 1, -2**31, -(1 << 28), -(1 << 14), 12, -12], np.int32)
    grid = np.array(np.meshgrid(edge, edge, edge, indexing="ij")).reshape(3, -1)
    rand = np.concatenate([rng.randint(-2**31, 2**31, (3, 4000), dtype=np.int64).astype(np.int32),
                           rng.randint(-300, 300, (3, 4000)).astype(np.int32)], axis=1)
    a, b, c = (np.ascontiguousarray(x) for x in np.concatenate([grid, rand], axis=1))
    out = np.zeros((a.size, 5), np.int32)
    ptr = ctypes.POINTER(ctypes.c_int)
    lib.dpx(*(x.ctypes.data_as(ptr) for x in (a, b, c)), a.size, out.ctypes.data_as(ptr))
    s = (a.astype(np.int64) + b).astype(np.int32)  # the 32-bit sum, wrapped
    want = [np.maximum(s, c), np.maximum(np.maximum(s, c), 0), np.maximum(np.maximum(a, b), c),
            np.maximum(np.maximum(np.maximum(a, b), c), 0), np.maximum(np.maximum(a, b), 0)]
    for k, w in enumerate(want):
        np.testing.assert_array_equal(out[:, k], w)
    assert (s != a.astype(np.int64) + b).any()  # wrapping sums were tested


@pytest.fixture(scope="module")
def forward_emu(tmp_path_factory):
    """csrc/sw_forward.cu built for the host (tests/torch_cuda_emu.py)."""
    lib = torch_cuda_emu.build("sw_forward", tmp_path_factory.mktemp("forward_emu"))
    cuda_build.declare(lib, ("sw_forward_launch", "sw_forward_i16_launch",
                             "sw_forward_split_launch", "sw_forward_q2_launch",
                             "sw_forward_q2_i16_launch"))
    return lib


def _forward_batch(Q, T, B, seed):
    """Mixed pairs with qlen 0, tlen 0, both at the bucket and past it."""
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=seed), Q, seed=seed)
    q_t, t_t, qlen, tlen = px.unpack_q2(torch.from_numpy(buf),
                                        px.resident_ref_codes(genome, "cpu"), Q, T)
    qlen[1], tlen[2], qlen[3], tlen[3], qlen[4], tlen[4] = 0, 0, Q, T, Q + 9, T + 2
    return q_t, t_t, qlen, tlen


def _emu_forward(launch, q_t, t_t, qlen, tlen, *before, sw=SW):
    Q, B = q_t.shape
    T = t_t.shape[0]
    dirs = torch.zeros((B, Q, T), dtype=torch.uint8)
    out = torch.zeros((3, B), dtype=torch.int32)
    assert launch(q_t.data_ptr(), t_t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), Q, T, B,
                  *sw, *before, dirs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                  out[2].data_ptr(), None) == 0
    return out[0], out[1], out[2], dirs


@pytest.mark.parametrize("Q,T,B", [(40, 64, 16), (33, 47, 12), (152, 256, 8), (256, 360, 8)],
                         ids=["40x64", "33x47", "152x256", "256x360"])
@pytest.mark.parametrize("variant", ["int32", "int16", "split2", "split4"])
@pytest.mark.parametrize("sw", [SW, FLAT], ids=["default", "flat"])
def test_forward_source_on_host_matches_plain(forward_emu, monkeypatch, sw, variant, Q, T, B):
    """sw_forward.cu's own kernels, run on the host: score, t_end, q_end
    and the (B, Q, T) dirs on valid cells equal `sw_forward_plain` (int16
    in its own accumulator), at T a multiple of 16 (16-byte stores) and
    not (byte stores), R = 2, 5 and 8 rows a lane (8: the 250 profile's bucket), with empty and clamped
    pairs, and with a gap extension of 0 (where the state the split
    kernels keep for idle lanes shows in the extension bits); the split
    kernels also equal `sw_forward_split_plain`."""
    q_t, t_t, qlen, tlen = _forward_batch(Q, T, B, seed=Q + T)
    acc = torch.int32
    if variant == "int16":
        monkeypatch.setenv("RSB_SW16", "1")
        acc = sw_cuda.pick_dtype(Q, T, sw)
        assert acc == torch.int16
        got = _emu_forward(forward_emu.sw_forward_i16_launch, q_t, t_t, qlen, tlen, sw=sw)
    elif variant == "int32":
        got = _emu_forward(forward_emu.sw_forward_launch, q_t, t_t, qlen, tlen, sw=sw)
    else:
        split = int(variant.removeprefix("split"))
        got = _emu_forward(forward_emu.sw_forward_split_launch, q_t, t_t, qlen, tlen, split,
                           sw=sw)
        plain = sw_cuda.sw_forward_split_plain(q_t, t_t, qlen, tlen, sw, split)
        valid = sw_cuda.valid_cells(qlen, tlen, Q, T)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], plain[:3]))
        assert torch.equal(torch.where(valid, got[3], 0), plain[3])
    want = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, acc)
    valid = sw_cuda.valid_cells(qlen, tlen, Q, T)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(torch.where(valid, got[3], 0), want[3])
    assert [int(x[i]) for i in (1, 2) for x in got[:3]] == [0, -1, 0] * 2
    assert (got[0] > 0).sum() > B // 2


@pytest.mark.parametrize("Q,T,B", [(152, 256, 13), (40, 47, 9), (256, 360, 9), (300, 80, 9),
                                   (512, 48, 10)],
                         ids=["152x256", "40x47", "256x360", "300x80", "512x48"])
@pytest.mark.parametrize("variant", ["int32", "int16"])
def test_q2_forward_source_on_host_matches_unpack_and_plain(forward_emu, monkeypatch, variant,
                                                            Q, T, B):
    """The forward's q2 loader (sw_forward_q2_launch and its int16 twin),
    run on the host on the engine's upload and a flat genome: score,
    t_end, q_end and the dirs on valid cells equal `sw_forward_plain` on
    `unpack_q2`'s decoded batch, at R = 5, 8 and 16 (Q = 512: a lane's
    last code bytes past the packed rows), T a multiple of 16 and not,
    B not a multiple of a block's 4 warps, N codes, qlen and tlen at 0, at
    the bucket and past it with codes in every row, and windows at the
    genome's end, against the genome itself (the clamp repeats its last
    code) and against its resident copy (which reads the padding)."""
    if variant == "int16":
        monkeypatch.setenv("RSB_SW16", "1")
    acc = sw_cuda.pick_dtype(Q, T, SW)
    assert acc == (torch.int16 if variant == "int16" else torch.int32)
    buf, genome = q2_edge_batch(Q, T, B, seed=Q + B)
    buf = torch.from_numpy(buf)
    launch = (forward_emu.sw_forward_q2_i16_launch if variant == "int16"
              else forward_emu.sw_forward_q2_launch)
    for ref in (torch.from_numpy(genome), px.resident_ref_codes(genome, "cpu")):
        dirs = torch.zeros((B, Q, T), dtype=torch.uint8)
        out = torch.zeros((3, B), dtype=torch.int32)
        assert launch(buf.data_ptr(), ref.data_ptr(), ref.shape[0], Q, T, B, *SW,
                      dirs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                      None) == 0
        q_t, t_t, qlen, tlen = px.unpack_q2(buf, ref, Q, T)
        want = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, SW, acc)
        for a, b in zip(out, want[:3]):
            assert torch.equal(a, b)
        valid = sw_cuda.valid_cells(qlen, tlen, Q, T)
        assert torch.equal(torch.where(valid, dirs, 0), want[3])
        assert [int(x[i]) for i in (1, 2) for x in out] == [0, -1, 0] * 2
        assert (out[0] > 0).sum() > B // 3
    # the windows at the end: the clamp's repeated last code, then the padding
    assert (px.unpack_q2(buf, torch.from_numpy(genome), Q, T)[1][T - 1, 5:8] == genome[-1]).all()
    assert (t_t[T // 2:, 5:8] == 4).all() and (q_t[:, 3:5] < 4).sum() > Q
    assert torch.equal(want[3], sw_cuda.sw_forward_q2(buf, ref, Q, T, SW)[3])


def test_q2_forward_source_refuses_bad_shapes(forward_emu):
    """The q2 entries launch nothing for Q over 512, a negative shape or an
    empty genome."""
    buf, genome = q2_edge_batch(40, 64, 8)
    ref = px.resident_ref_codes(genome, "cpu")
    dirs = torch.zeros((8, 40, 64), dtype=torch.uint8)
    out = torch.zeros((3, 8), dtype=torch.int32)
    ptrs = (dirs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), None)
    for launch in (forward_emu.sw_forward_q2_launch, forward_emu.sw_forward_q2_i16_launch):
        for Q, T, B, n in ((513, 64, 8, ref.shape[0]), (40, -1, 8, ref.shape[0]),
                           (40, 64, 8, 0)):
            assert launch(torch.from_numpy(buf).data_ptr(), ref.data_ptr(), n, Q, T, B, *SW,
                          *ptrs) != 0
    assert not dirs.any() and not out.any()


def test_split_source_refuses_bad_splits(forward_emu):
    """The split entry launches nothing for a split other than 2 or 4, a
    width the split does not divide, or Q over 512."""
    q_t, t_t, qlen, tlen = _forward_batch(40, 64, 12, seed=1)
    for split in (1, 3, 8):
        with pytest.raises(AssertionError):
            _emu_forward(forward_emu.sw_forward_split_launch, q_t, t_t, qlen, tlen, split)
    with pytest.raises(AssertionError):  # 10 pairs in groups of 4
        _emu_forward(forward_emu.sw_forward_split_launch, q_t[:, :10], t_t[:, :10], qlen[:10],
                     tlen[:10], 4)
    big = torch.zeros((513, 4), dtype=torch.uint8)
    with pytest.raises(AssertionError):
        _emu_forward(forward_emu.sw_forward_split_launch, big, t_t[:, :4], qlen[:4], tlen[:4],
                     2)


@pytest.fixture(scope="module")
def find_emu(tmp_path_factory):
    """csrc/index_find.cu built for the host (tests/torch_cuda_emu.py)."""
    lib = torch_cuda_emu.build("index_find", tmp_path_factory.mktemp("find_emu"))
    cuda_build.declare(lib, ("index_find_launch",))
    return lib


def _find(lib, hashes, buckets, bits, keys):
    """The plain version's answer, after holding the kernel's source to it
    (the emulated device holds 6 blocks of 256 threads, two queries a
    thread, so a batch over 3072 queries strides over the grid)."""
    h, b, q = (torch.from_numpy(np.ascontiguousarray(a).view(np.int64)) for a in
               (hashes, buckets, keys))
    want = psd.index_find_device(h, b, bits, q)
    got = torch.full_like(q, 7)
    assert lib.index_find_launch(h.data_ptr(), h.numel(), b.data_ptr(), bits, q.data_ptr(),
                                 q.numel(), got.data_ptr(), None) == 0
    assert torch.equal(got, want)
    return want.numpy()


def _stub_keys(h, rng):
    """Hits anywhere in their runs, their neighbours, misses, 0, the top
    hash and the smallest hash (the bucket quirk)."""
    picks = rng.randint(0, h.shape[0], 1000)
    return np.concatenate([h[picks], h[picks] + np.uint64(1), h[picks] - np.uint64(1),
                           rng.randint(0, 2**63, 300).astype(np.uint64) * np.uint64(2),
                           np.array([0, 2**64 - 1, h[0], h[-1]], np.uint64)])


def test_index_find_source_on_host_matches_plain_on_stubs(find_emu):
    """Random stubs with buckets up to tens of hashes (searches of five
    steps and more) and narrow ones, and the sentinel
    stub (a run of the 0xFF..F hash)."""
    rng = np.random.RandomState(5)
    widest = 0
    for stub in [_random_stub(rng) for _ in range(8)] + [_sentinel_stub()]:
        b = stub.randstrobe_start_indices
        widest = max(widest, int(np.diff(b.astype(np.int64)).max()))
        got = _find(find_emu, stub.hashes, b, stub.bits, _stub_keys(stub.hashes, rng))
        assert (got >= 0).any() and (got == -1).any()
    assert widest > 3 * WIDE


def test_index_find_source_on_host_matches_jax_on_the_world(find_emu):
    """The repetitive world's index (tandem repeats: long runs and wide
    buckets) at its own bits and at 4 bits (every bucket
    wide), against the JAX package's `index_find_device`; and an index
    whose hashes are all equal, which finds nothing."""
    index = _repetitive_world()[3]
    h = np.asarray(index.hashes)
    rng = np.random.RandomState(6)
    keys = _stub_keys(h, rng)
    for bits in (index.bits, 4):
        if bits == index.bits:  # with the quirk: the smallest hash is unreachable
            b = np.asarray(index.randstrobe_start_indices)
        else:  # bucket k from the first hash whose top bits reach k
            tops = (h >> np.uint64(64 - bits)).astype(np.int64)
            b = np.searchsorted(tops, np.arange((1 << bits) + 1)).astype(np.uint64)
        got = _find(find_emu, h, b, bits, keys)
        want = np.asarray(jsd.index_find_device(jnp.asarray(h), jnp.asarray(b), jnp.uint64(bits),
                                                jnp.asarray(keys)))
        np.testing.assert_array_equal(got, want)
        assert (got[:1000] >= 0).sum() > 800 and (got[-2] == -1) == (bits == index.bits)
        assert np.diff(b.astype(np.int64)).max() > WIDE
    same = np.full(9, h[1000], np.uint64)
    b = np.full((1 << 8) + 1, 9, np.uint64)
    got = _find(find_emu, same, b, 8, np.array([h[1000], 0, 2**64 - 1], np.uint64))
    assert (got == -1).all()
