"""Batched affine-gap local Smith-Waterman forward pass: the CUDA kernel
(csrc/sw_forward.cu) and its plain PyTorch version.

Counterpart of rabbitsalign_tpu/ops/sw_pallas.py (the Pallas kernel and
its tie-break reduction); the plain version is the twin of
rabbitsalign_tpu/ops/sw_jax.py:sw_forward. Scoring: +A for equal codes
< 4, else -B; a gap of length L costs O + (L-1)*E; H is floored at 0.

Direction byte per cell:

    bits 0-1: H source (0 stop, 1 diagonal, 2 E = gap in the target
              'I', 3 F = gap in the query 'D')
    bit 2:    E formed by extension (vs open)
    bit 3:    F formed by extension (vs open)
    bit 4:    raw code equality (N against N reads as '=')

Tie-breaks: extension wins over opening; F wins an E/F tie; the diagonal
wins a tie with the gap; each row keeps its first (smallest t) best, and
the pair's end is max score, then min t, then min q. A score-0 pair has
t_end = -1 and q_end = 0.

Layout: inputs (Q, B) / (T, B) with the pair index innermost, as the
Pallas core takes them; dirs are (B, Q, T), each pair's Q x T cells
contiguous and row-major (the forward kernel is one warp per pair and
writes them in whole 32-byte sectors). Lengths past Q or T are clamped to
the bucket. Only cells inside the valid region are defined in the
kernel's dirs (the plain version writes 0 elsewhere). `permute_dirs`
turns them into the Pallas kernels' (Dpad, Q, B) layout for comparisons;
the mapping path never calls it.

Accumulator: int32, or int16 under ``RSB_SW16`` where the span bound of
`pick_dtype` holds (the rule of sw_pallas._pick_dtype). The int16
configuration starts E and F at NEG16 and passes the H and E of a lane's
bottom row to the next lane as two int16 halves of one shuffle; wherever
the bound holds its outputs equal the int32 ones.

`sw_forward_q2` is the forward on the engine's q2 upload and the flat
resident genome, which the kernel decodes and gathers itself (the main
path's input, csrc/sw_forward.cu's Q2In loader): the outputs of
`sw_forward` on `unpack_q2`'s decoded batch, without the decoded batch.

`sw_forward_split` is the cross-pair ILP variant (a warp for 2 or 4
pairs, int32, (B, Q, T) dirs), the counterpart of
tests/sanitize/ilp_probe.py's `_kernel_split`; only the ILP probe
(tools/ilp_probe.py) runs it.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple, Tuple

import torch

NEG = -(1 << 28)
NEG16 = -(1 << 14)

# launches of the int32 and int16 CUDA kernels by sw_forward, sw_forward_q2
# and extend_device.extend_q2_enqueue, and of the split kernel by
# sw_forward_split; calls that take the plain version (CPU tensors) are not
# counted. Mapping workers launch from several threads, so updates hold
# _count_lock.
launches = 0
launches_i16 = 0
launches_split = 0
SPLITS = (2, 4)  # pairs per warp of sw_forward_split
MAX_Q = 512  # the forward kernel's rows: 32 lanes x 16
_count_lock = threading.Lock()


class SwParams(NamedTuple):
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


def pick_dtype(Q: int, T: int, params: SwParams) -> torch.dtype:
    """DP accumulator dtype for a (Q, T) bucket, read per call:
    torch.int32 unless ``RSB_SW16`` is set to something other than ""
    or "0", and then torch.int16 only while every value and every
    compared difference stays under 2**15 (the span bound of
    rabbitsalign_tpu/ops/sw_pallas.py:_pick_dtype, verbatim)."""
    if os.environ.get("RSB_SW16", "") in ("", "0"):
        return torch.int32
    worst_h = params.match * min(Q, T)
    D = Q + T - 1
    span = (worst_h + (1 << 14) + params.gap_extend * D
            + params.gap_open + params.mismatch + 64)
    if span < (1 << 15):
        return torch.int16
    return torch.int32


def _check_inputs(q_t, t_t, qlen, tlen) -> None:
    if q_t.dim() != 2 or t_t.dim() != 2 or q_t.shape[1] != t_t.shape[1]:
        raise ValueError(f"q_t (Q, B) and t_t (T, B) expected, got "
                         f"{tuple(q_t.shape)} and {tuple(t_t.shape)}")
    B = q_t.shape[1]
    if qlen.shape != (B,) or tlen.shape != (B,):
        raise ValueError("qlen and tlen must have shape (B,)")
    if q_t.dtype != torch.uint8 or t_t.dtype != torch.uint8:
        raise TypeError("q_t and t_t must be uint8 codes")
    if qlen.dtype != torch.int32 or tlen.dtype != torch.int32:
        raise TypeError("qlen and tlen must be int32")
    for x in (t_t, qlen, tlen):
        if x.device != q_t.device:
            raise ValueError("all inputs must be on one device")


def sw_forward(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
               tlen: torch.Tensor, params: SwParams
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q_t (Q, B) u8, t_t (T, B) u8, qlen/tlen (B,) i32 -> (score, t_end,
    q_end (B,) i32, dirs (B, Q, T) u8), in the accumulator dtype of
    `pick_dtype`. CPU tensors take the plain version; CUDA tensors launch
    the kernel of that dtype (Q at most MAX_Q)."""
    _check_inputs(q_t, t_t, qlen, tlen)
    Q, B = q_t.shape
    T = t_t.shape[0]
    acc = pick_dtype(Q, T, params)
    if q_t.device.type == "cpu":
        return sw_forward_plain(q_t, t_t, qlen, tlen, params, acc)
    lib = _cuda_lib(q_t, "sw_forward")
    i16 = acc == torch.int16
    out = _launch_forward(lib.sw_forward_i16_launch if i16 else lib.sw_forward_launch,
                          "sw_forward", q_t, t_t, qlen, tlen, params, (B, Q, T))
    count_launch(i16)
    return out


def sw_forward_q2(buf: torch.Tensor, ref_codes: torch.Tensor, Q: int, T: int,
                  params: SwParams
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward on the q2 upload `buf` ((ceil(Q/4) + ceil(Q/8) + 8, B)
    u8, engine `fill_batch_q2`) against the flat resident genome
    `ref_codes` on its device: the outputs of `sw_forward` on
    `unpack_q2(buf, ref_codes, Q, T)`, in the accumulator of `pick_dtype`.
    CPU tensors take that plain chain; CUDA tensors launch the kernel with
    the q2 loader, which decodes and gathers in its prologue (Q at most
    MAX_Q)."""
    from .extend_device import q2_rows, unpack_q2

    rows = q2_rows(Q)
    if buf.dim() != 2 or buf.dtype != torch.uint8 or buf.shape[0] != rows:
        raise ValueError(f"sw_forward_q2: a ({rows}, B) uint8 q2 buffer expected, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if ref_codes.dim() != 1 or ref_codes.dtype != torch.uint8 or ref_codes.device != buf.device:
        raise ValueError("sw_forward_q2: the genome must be a flat uint8 tensor on the "
                         "buffer's device")
    acc = pick_dtype(Q, T, params)
    if buf.device.type == "cpu":
        return sw_forward_plain(*unpack_q2(buf, ref_codes, Q, T), params, acc)
    lib = _cuda_lib(buf, "sw_forward_q2")
    if Q > MAX_Q:
        raise ValueError(f"sw_forward_q2: the kernel takes Q <= {MAX_Q}, not {Q}")
    B = buf.shape[1]
    buf, ref_codes = buf.contiguous(), ref_codes.contiguous()
    dev = buf.device
    dirs = torch.empty((B, Q, T), dtype=torch.uint8, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    i16 = acc == torch.int16
    launch = lib.sw_forward_q2_i16_launch if i16 else lib.sw_forward_q2_launch
    with torch.cuda.device(dev):
        err = launch(buf.data_ptr(), ref_codes.data_ptr(), ref_codes.shape[0], Q, T, B,
                     *params, dirs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                     out[2].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sw_forward_q2 kernel launch failed (CUDA error {err})")
    count_launch(i16)
    return out[0], out[1], out[2], dirs


def count_launch(i16: bool) -> None:
    """Count one launch of the int16 or the int32 forward kernel."""
    global launches, launches_i16
    with _count_lock:
        if i16:
            launches_i16 += 1
        else:
            launches += 1


def sw_forward_split(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor, params: SwParams, split: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int32 forward with `split` (2 or 4) pairs a warp: pair b
    belongs to column group b // (B / split), as the lane groups of
    `_kernel_split`. Same arguments and outputs as `sw_forward`, dirs
    (B, Q, T); it equals the int32 `sw_forward` byte for byte on valid
    cells. CPU tensors take `sw_forward_split_plain`; CUDA tensors launch
    the split kernel (Q at most MAX_Q)."""
    global launches_split
    _check_inputs(q_t, t_t, qlen, tlen)
    _check_split(q_t.shape[1], split)
    if q_t.device.type == "cpu":
        return sw_forward_split_plain(q_t, t_t, qlen, tlen, params, split)
    lib = _cuda_lib(q_t, "sw_forward_split")
    Q, B = q_t.shape
    T = t_t.shape[0]
    out = _launch_forward(lib.sw_forward_split_launch, "sw_forward_split", q_t, t_t, qlen,
                          tlen, params, (B, Q, T), before=(split,))
    with _count_lock:
        launches_split += 1
    return out


def _check_split(B: int, split: int) -> None:
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, not {split}")
    if B % split:
        raise ValueError(f"the batch width {B} is not a multiple of split={split}")


def _cuda_lib(q_t: torch.Tensor, name: str):
    if q_t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_t.device}")
    from .cuda_build import load_kernels

    return load_kernels()


def _launch_forward(launch, name: str, q_t, t_t, qlen, tlen, params: SwParams,
                    dirs_shape, before=()):
    """Allocate the outputs (dirs of `dirs_shape`), launch `launch` on the
    current stream of q_t's device and raise if the launch was refused.
    `before` goes between the scoring arguments and dirs. The kernels take
    Q up to MAX_Q."""
    Q, B = q_t.shape
    T = t_t.shape[0]
    if Q > MAX_Q:
        raise ValueError(f"{name}: the kernel takes Q <= {MAX_Q}, not {Q}")
    q_t, t_t = q_t.contiguous(), t_t.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    dev = q_t.device
    dirs = torch.empty(dirs_shape, dtype=torch.uint8, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    score, t_end, q_end = out[0], out[1], out[2]
    with torch.cuda.device(dev):
        err = launch(
            q_t.data_ptr(), t_t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            Q, T, B, params.match, params.mismatch, params.gap_open,
            params.gap_extend, *before, dirs.data_ptr(), score.data_ptr(),
            t_end.data_ptr(), q_end.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    return score, t_end, q_end, dirs


def permute_dirs(dirs: torch.Tensor, layout: str) -> torch.Tensor:
    """The forward's (B, Q, T) dirs in another layout, for comparisons:
    "dqb", the Pallas kernels' (Dpad, Q, B) with cell (q, t) at
    [q + t, q, b], Dpad = Q + T - 1 rounded up to 8, and 0 where t = d - q
    is outside [0, T)."""
    B, Q, T = dirs.shape
    if layout != "dqb":
        raise ValueError(f"layout must be 'dqb', not {layout!r}")
    out = torch.zeros(((Q + T - 1 + 7) // 8 * 8, Q, B), dtype=dirs.dtype, device=dirs.device)
    for q in range(Q):
        out[q:q + T, q, :] = dirs[:, q, :].T
    return out


def valid_cells(qlen: torch.Tensor, tlen: torch.Tensor, Q: int, T: int) -> torch.Tensor:
    """(B, Q, T) bool: the cells of the forward's dirs that are defined
    (q < qlen, t < tlen)."""
    qi = torch.arange(Q, device=qlen.device)[None, :, None]
    ti = torch.arange(T, device=qlen.device)[None, None, :]
    return (qi < qlen[:, None, None]) & (ti < tlen[:, None, None])


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[q] -> x[q-1] along dim 0, with `fill` at q = 0."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]])


def sw_forward_plain(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor, params: SwParams, acc: torch.dtype = torch.int32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain torch ops: one step per anti-diagonal d
    over the (Q, B) plane of cells (q, t = d - q), as sw_jax.sw_forward.
    The DP planes are kept in `acc` (torch.int32, or torch.int16 with E
    and F starting at NEG16); the outputs are int32 either way."""
    if acc not in (torch.int32, torch.int16):
        raise TypeError(f"acc must be torch.int32 or torch.int16, not {acc}")
    Q, B = q_t.shape
    T = t_t.shape[0]
    D = Q + T - 1
    dev = q_t.device
    neg = NEG16 if acc == torch.int16 else NEG
    A, Bm, O, Eg = params
    qlen = qlen.clamp(0, Q).to(acc)
    tlen = tlen.clamp(0, T).to(acc)
    q = q_t.to(acc)
    # target rows past T (reached only by invalid cells) read as 'N'
    t_pad = torch.cat([t_t.to(acc), torch.full((Q - 1, B), 4, dtype=acc, device=dev)])
    q_idx = torch.arange(Q, dtype=acc, device=dev)[:, None]
    q_valid = q_idx < qlen[None, :]
    q_scores = q < 4
    dirs = torch.zeros((B, Q, T), dtype=torch.uint8, device=dev)

    zeros = torch.zeros((Q, B), dtype=acc, device=dev)
    H1, H2 = zeros, zeros  # H on diagonals d-1 and d-2
    E1 = torch.full((Q, B), neg, dtype=acc, device=dev)
    F1 = E1
    revt = torch.full((Q, B), 4, dtype=acc, device=dev)  # revt[q] = t code at d - q
    best_h = zeros
    best_t = torch.full((Q, B), -1, dtype=acc, device=dev)
    for d in range(D):
        revt = torch.cat([t_pad[d : d + 1], revt[:-1]])
        e_open = _shift_down(H1, 0) - O
        e_ext = _shift_down(E1, neg) - Eg
        e_is_ext = e_open <= e_ext
        E = torch.maximum(e_open, e_ext)
        f_open = H1 - O
        f_ext = F1 - Eg
        f_is_ext = f_open <= f_ext
        F = torch.maximum(f_open, f_ext)
        eq = q == revt
        dsub = _shift_down(H2, 0) + torch.where(eq & q_scores, A, -Bm).to(acc)
        e1 = E.clamp(min=0)
        f1 = F.clamp(min=0)
        gap1 = torch.maximum(e1, f1)
        H = torch.maximum(dsub, gap1).clamp(min=0)

        t_vec = d - q_idx
        valid = (t_vec >= 0) & (t_vec < tlen[None, :]) & q_valid
        H = torch.where(valid, H, 0)
        E = torch.where(valid, E, neg)
        F = torch.where(valid, F, neg)
        h_src = torch.where(H == 0, 0, torch.where(
            dsub >= gap1, 1, torch.where(e1 > f1, 2, 3)))
        dv = (h_src | (e_is_ext.to(torch.int32) << 2) | (f_is_ext.to(torch.int32) << 3)
              | (eq.to(torch.int32) << 4))
        dv = torch.where(valid, dv, 0).to(torch.uint8)
        lo, hi = max(0, d - T + 1), min(Q - 1, d)
        rows = torch.arange(lo, hi + 1, device=dev)
        dirs[:, rows, d - rows] = dv[lo : hi + 1].T

        upd = H > best_h  # strict: the first (smallest t) best per row
        best_h = torch.where(upd, H, best_h)
        best_t = torch.where(upd, t_vec.expand(Q, B), best_t)
        H2, H1, E1, F1 = H1, H, E, F

    i32 = torch.int32
    best_h, best_t = best_h.to(i32), best_t.to(i32)
    score = best_h.max(dim=0).values
    is_best = best_h == score[None, :]
    t_end = torch.where(is_best, best_t, 2**30).min(dim=0).values
    q_end = (is_best & (best_t == t_end[None, :])).to(i32).argmax(dim=0).to(i32)
    return score, t_end, q_end, dirs


def sw_forward_split_plain(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
                           tlen: torch.Tensor, params: SwParams, split: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`sw_forward_plain` (int32) on each of the `split` column groups,
    concatenated: the lane groups of `_kernel_split`; dirs (B, Q, T), as
    the split kernel writes them."""
    _check_split(q_t.shape[1], split)
    parts = [sw_forward_plain(*(x.chunk(split, dim=-1)[s] for x in (q_t, t_t, qlen, tlen)),
                              params)
             for s in range(split)]
    score, t_end, q_end, dirs = (torch.cat(xs, dim=0) for xs in zip(*parts))
    return score, t_end, q_end, dirs
