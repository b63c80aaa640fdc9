"""The traceback's packed epilogue and tile schedule, on the CPU.

- `tb_cuda.sw_traceback_packed` on CPU tensors (its plain version) equals
  the JAX package's `_pack_rle_output` over `traceback_rle`, byte for
  byte, on mixed pairs plus a score-0 pair, an empty query, pairs with
  more than RLE_M runs and pairs that end at the (Q-1, T-1) corner.
- The wrappers' contract: CPU tensors count no launch, other devices,
  shapes and dtypes raise.
- A numpy emulation of the CUDA kernel's tile schedule
  (tests/torch_tb_tiles.py: two tile buffers, the refill rule, the
  diagonal prefetch, 16-byte column rounding, clipping at row 0 and
  column 0, and the rounds that take a diagonal run at once from the
  lanes' ballots) walks the plain forward's dirs, with the cells outside
  qlen x tlen poisoned, and equals `sw_traceback_plain`.
Everything is integer, so every comparison is exact."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from rabbitsalign_tpu.ops import extend_device as jx
from rabbitsalign_tpu.ops.extend_portable import traceback_rle
from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu.ops.sw_jax import sw_forward as jax_sw_forward
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams

from .torch_extend_cases import gap_pairs, mixed_pairs, q2_batch
from .torch_tb_tiles import tile_walk_batch

SW_PARAMS = [
    SwParams(2, 8, 12, 1),   # defaults
    SwParams(1, 1, 2, 1),    # flat scoring: dense score ties
    SwParams(3, 2, 3, 0),    # free gap extension
]


def _batch(Q, T, B, seed):
    """(q_t, t_t, qlen, tlen) CPU tensors: mixed pairs, then gap_pairs."""
    pairs = mixed_pairs(Q, T, B, seed=seed) + gap_pairs(Q, T, seed)
    buf, genome = q2_batch(pairs, Q, seed=seed)
    return px.unpack_q2(torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T)


@pytest.mark.parametrize("Q,T", [(128, 160), (120, 150)])
@pytest.mark.parametrize("sw", SW_PARAMS, ids=["default", "flat", "free-extend"])
def test_packed_traceback_matches_jax_pack(Q, T, sw):
    q_t, t_t, qlen, tlen = _batch(Q, T, 28, seed=Q + T)
    js, jte, jqe, jd = jax_sw_forward(q_t.numpy().T.copy(), t_t.numpy().T.copy(),
                                      qlen.numpy(), tlen.numpy(), JaxSwParams(*sw))
    j_runs_op, j_runs_len, j_meta = traceback_rle(jd, js, jte, jqe)
    want = np.asarray(jx._pack_rle_output(j_runs_op, j_runs_len, js, jte, jqe, j_meta))
    score, t_end, q_end, dirs = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    launches = tb_cuda.launches
    got = tb_cuda.sw_traceback_packed(dirs, score, t_end, q_end)
    assert tb_cuda.launches == launches
    assert got.dtype == torch.uint8 and got.shape == (tb_cuda.OUT_ROWS, q_t.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain composition, and the name the fused extend's callers use
    runs_op, runs_len, meta = tb_cuda.sw_traceback(dirs, score, t_end, q_end)
    np.testing.assert_array_equal(
        px._pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta).numpy(), want)

    fields = px.unpack_output(got.numpy())
    n_runs, sc, te, qe = fields[2], fields[3], fields[4], fields[5]
    assert ((sc == 0) & (te == 0xFFFF)).any()   # t_end -1 packs as (0xFF, 0xFF)
    assert ((te == T - 1) & (qe == Q - 1)).any()  # the corner pair
    assert (qlen.numpy() == 0).any()
    if sw == SW_PARAMS[0]:
        assert (n_runs == 0xFFFF).any(), "an overflow pair must hit the 0xFFFF marker"


def test_traceback_wrappers_contract():
    q_t, t_t, qlen, tlen = _batch(40, 72, 14, seed=1)
    score, t_end, q_end, dirs = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, SW_PARAMS[0])
    before = tb_cuda.launches
    runs = tb_cuda.sw_traceback(dirs, score, t_end, q_end)
    packed = tb_cuda.sw_traceback_packed(dirs, score, t_end, q_end)
    assert tb_cuda.launches == before
    assert torch.equal(packed, tb_cuda.pack_rle_output(*runs[:2], score, t_end, q_end, runs[2]))
    for fn in (tb_cuda.sw_traceback, tb_cuda.sw_traceback_packed):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(dirs.to("meta"), score.to("meta"), t_end.to("meta"), q_end.to("meta"))
        with pytest.raises(ValueError):
            fn(dirs[0], score, t_end, q_end)                 # not (B, Q, T)
        with pytest.raises(ValueError):
            fn(dirs.to(torch.int32), score, t_end, q_end)    # not uint8
        with pytest.raises(ValueError):
            fn(dirs, score.to(torch.int64), t_end, q_end)    # not int32
        with pytest.raises(ValueError):
            fn(dirs, score[:-1], t_end, q_end)               # not (B,)
    assert tb_cuda.launches == before


@pytest.mark.parametrize("K", [2, 4, 32])
@pytest.mark.parametrize("Q,T", [(64, 96), (61, 90)], ids=["T%16==0", "T%16!=0"])
def test_tile_schedule_matches_plain_walk(K, Q, T):
    """The kernel's schedule over the plain forward's dirs, its invalid
    cells poisoned, under every scoring: equal to sw_traceback_plain, with
    synchronous refills, (on the 16-byte path) prefetch hits and, with
    32-row tiles, diagonal runs taken several steps a round."""
    stats_all = {"steps": 0, "rounds": 0, "loads": 0, "hits": 0, "pairs": 0}
    for i, sw in enumerate(SW_PARAMS):
        q_t, t_t, qlen, tlen = _batch(Q, T, 35, seed=K + i)
        score, t_end, q_end, dirs = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
        want = tb_cuda.sw_traceback_plain(dirs, score, t_end, q_end)
        valid = sw_cuda.valid_cells(qlen, tlen, Q, T).numpy()
        poison = np.random.RandomState(i).randint(0, 256, dirs.shape).astype(np.uint8)
        plane = np.where(valid, dirs.numpy(), poison)
        got, stats = tile_walk_batch(plane, score.numpy(), t_end.numpy(), q_end.numpy(), K,
                                     seed=i)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        aligned = (score > 0).numpy()
        assert (stats["steps"][aligned] > 0).all()
        for k in ("steps", "rounds", "loads", "hits"):
            stats_all[k] += int(stats[k].sum())
        stats_all["pairs"] += int(aligned.sum())
    assert stats_all["loads"] > stats_all["pairs"]  # refills beyond each walk's first tile
    assert (stats_all["hits"] > 0) == (T % 16 == 0)
    if K == 32:  # diagonal runs taken many steps a round
        assert stats_all["rounds"] * 3 < stats_all["steps"]
