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
Pallas core takes them; dirs are (Q, T, B). Lengths past Q or T are
clamped to the bucket. Only cells inside the valid region are defined in
the kernel's dirs (the plain version writes 0 elsewhere).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NEG = -(1 << 28)

# launches of the CUDA kernel by sw_forward; calls that take the plain
# version (CPU tensors) are not counted
launches = 0


class SwParams(NamedTuple):
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


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
    q_end (B,) i32, dirs (Q, T, B) u8). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    _check_inputs(q_t, t_t, qlen, tlen)
    if q_t.device.type == "cpu":
        return sw_forward_plain(q_t, t_t, qlen, tlen, params)
    if q_t.device.type != "cuda":
        raise ValueError(f"sw_forward: unsupported device {q_t.device}")
    from .cuda_build import load_kernels

    lib = load_kernels()
    q_t, t_t = q_t.contiguous(), t_t.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Q, B = q_t.shape
    T = t_t.shape[0]
    dev = q_t.device
    dirs = torch.empty((Q, T, B), dtype=torch.uint8, device=dev)
    h_row = torch.empty((T, B), dtype=torch.int32, device=dev)
    e_row = torch.empty((T, B), dtype=torch.int32, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    score, t_end, q_end = out[0], out[1], out[2]
    with torch.cuda.device(dev):
        err = lib.sw_forward_launch(
            q_t.data_ptr(), t_t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            Q, T, B, params.match, params.mismatch, params.gap_open,
            params.gap_extend, dirs.data_ptr(), h_row.data_ptr(),
            e_row.data_ptr(), score.data_ptr(), t_end.data_ptr(),
            q_end.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sw_forward kernel launch failed (CUDA error {err})")
    launches += 1
    return score, t_end, q_end, dirs


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[q] -> x[q-1] along dim 0, with `fill` at q = 0."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]])


def sw_forward_plain(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
                     tlen: torch.Tensor, params: SwParams
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain torch ops: one step per anti-diagonal d
    over the (Q, B) plane of cells (q, t = d - q), as sw_jax.sw_forward."""
    Q, B = q_t.shape
    T = t_t.shape[0]
    D = Q + T - 1
    dev = q_t.device
    i32 = torch.int32
    A, Bm, O, Eg = params
    qlen = qlen.to(i32).clamp(0, Q)
    tlen = tlen.to(i32).clamp(0, T)
    q = q_t.to(i32)
    # target rows past T (reached only by invalid cells) read as 'N'
    t_pad = torch.cat([t_t.to(i32), torch.full((Q - 1, B), 4, dtype=i32, device=dev)])
    q_idx = torch.arange(Q, dtype=i32, device=dev)[:, None]
    q_valid = q_idx < qlen[None, :]
    q_scores = q < 4
    dirs = torch.zeros((Q, T, B), dtype=torch.uint8, device=dev)

    zeros = torch.zeros((Q, B), dtype=i32, device=dev)
    H1, H2 = zeros, zeros  # H on diagonals d-1 and d-2
    E1 = torch.full((Q, B), NEG, dtype=i32, device=dev)
    F1 = E1
    revt = torch.full((Q, B), 4, dtype=i32, device=dev)  # revt[q] = t code at d - q
    best_h = zeros
    best_t = torch.full((Q, B), -1, dtype=i32, device=dev)
    for d in range(D):
        revt = torch.cat([t_pad[d : d + 1], revt[:-1]])
        e_open = _shift_down(H1, 0) - O
        e_ext = _shift_down(E1, NEG) - Eg
        e_is_ext = e_open <= e_ext
        E = torch.maximum(e_open, e_ext)
        f_open = H1 - O
        f_ext = F1 - Eg
        f_is_ext = f_open <= f_ext
        F = torch.maximum(f_open, f_ext)
        eq = q == revt
        dsub = _shift_down(H2, 0) + torch.where(eq & q_scores, A, -Bm).to(i32)
        e1 = E.clamp(min=0)
        f1 = F.clamp(min=0)
        gap1 = torch.maximum(e1, f1)
        H = torch.maximum(dsub, gap1).clamp(min=0)

        t_vec = d - q_idx
        valid = (t_vec >= 0) & (t_vec < tlen[None, :]) & q_valid
        H = torch.where(valid, H, 0)
        E = torch.where(valid, E, NEG)
        F = torch.where(valid, F, NEG)
        h_src = torch.where(H == 0, 0, torch.where(
            dsub >= gap1, 1, torch.where(e1 > f1, 2, 3)))
        dv = (h_src | (e_is_ext.to(i32) << 2) | (f_is_ext.to(i32) << 3)
              | (eq.to(i32) << 4))
        dv = torch.where(valid, dv, 0).to(torch.uint8)
        lo, hi = max(0, d - T + 1), min(Q - 1, d)
        rows = torch.arange(lo, hi + 1, device=dev)
        dirs[rows, d - rows] = dv[lo : hi + 1]

        upd = H > best_h  # strict: the first (smallest t) best per row
        best_h = torch.where(upd, H, best_h)
        best_t = torch.where(upd, t_vec.expand(Q, B), best_t)
        H2, H1, E1, F1 = H1, H, E, F

    score = best_h.max(dim=0).values
    is_best = best_h == score[None, :]
    t_end = torch.where(is_best, best_t, 2**30).min(dim=0).values
    q_end = (is_best & (best_t == t_end[None, :])).to(i32).argmax(dim=0).to(i32)
    return score, t_end, q_end, dirs
