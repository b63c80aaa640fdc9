"""Traceback walk with in-walk run-length encoding: the CUDA kernel
(csrc/sw_traceback.cu) and its plain PyTorch version, with two outputs.

Counterpart of rabbitsalign_tpu/ops/tb_pallas.py; the plain version is
the twin of rabbitsalign_tpu/ops/extend_portable.py:traceback_rle, over
this port's (B, Q, T) dirs layout (ops/sw_cuda.py): each pair's walk reads
its own contiguous Q x T plane.

Each pair's walker starts at (t_end, q_end) in layer H when score > 0.
In layer H the cell's source decides: 0 stops (begin = cell + 1), 1 emits
'='/'X' from bit 4 and steps t-1, q-1, 2 emits I and steps q-1 (staying
in layer E while bit 2 is set), 3 emits D and steps t-1 (staying in F
while bit 3 is set); layers E and F repeat I or D. Walking off the matrix
ends the walk with begin = moved cell + 1. Edits = X + I + D.

`sw_traceback` returns the tb_pallas contract: runs_op / runs_len
(RLE_M, B) i32 with the i-th completed run (counted from the cigar's end)
at slot RLE_M-1-i, so ascending slots read in cigar order; meta (8, B) i32
rows [t_begin, q_begin, edits, n_runs, 0, 0, 0, 0]. Past RLE_M runs only
the first RLE_M completed runs are kept and n_runs keeps counting.

`sw_traceback_packed` returns the engine's transfer buffer, (OUT_ROWS, B)
u8 (engine.cpp chunk_set_device_results): rows [0, M) run length lo
byte, rows [M, 2M) (op << 5) | (length >> 8), then score, t_end, q_end,
t_begin, q_begin, edits and n_runs as u16 (lo, hi) row pairs of their
two's complement (t_end -1 of a score-0 pair packs as 0xFF, 0xFF); n_runs
0xFFFF marks a pair with more than RLE_M runs, which the host re-aligns.
The kernel writes it itself; its plain version is `pack_rle_output` over
`sw_traceback_plain`.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

RLE_M = 32  # run slots per pair; = engine.cpp chunk_set_device_results M
OUT_ROWS = 2 * RLE_M + 14  # rows of the packed transfer buffer

OP_NONE = 0
OP_EQ = 1
OP_X = 2
OP_I = 3
OP_D = 4

# walker layers
_H = 0
_E = 1
_F = 2
_DONE = 3

# launches of the CUDA kernel by sw_traceback, sw_traceback_packed and
# extend_device.extend_q2_enqueue; plain-version calls and B = 0 (nothing
# to launch) are not counted.
# Mapping workers launch from several threads, so updates hold _count_lock.
launches = 0
_count_lock = threading.Lock()


def _check_inputs(name, dirs, score, t_end, q_end) -> None:
    if dirs.dim() != 3 or dirs.dtype != torch.uint8:
        raise ValueError(f"{name}: dirs must be a (B, Q, T) uint8 tensor")
    B = dirs.shape[0]
    for x in (score, t_end, q_end):
        if x.shape != (B,) or x.dtype != torch.int32 or x.device != dirs.device:
            raise ValueError(f"{name}: score, t_end, q_end must be (B,) int32 on the dirs device")
    if dirs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dirs.device}")


def count_launch() -> None:
    """Count one launch of the traceback kernel."""
    global launches
    with _count_lock:
        launches += 1


def _launch(name, launch, dirs, score, t_end, q_end, outs) -> None:
    """Launch `launch` on the current stream of dirs' device, writing the
    preallocated `outs`; raise if the launch was refused."""
    B, Q, T = dirs.shape
    if B == 0:
        return
    dirs = dirs.contiguous()
    score, t_end, q_end = score.contiguous(), t_end.contiguous(), q_end.contiguous()
    dev = dirs.device
    with torch.cuda.device(dev):
        err = launch(dirs.data_ptr(), score.data_ptr(), t_end.data_ptr(), q_end.data_ptr(),
                     Q, T, B, *(x.data_ptr() for x in outs),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    count_launch()


def sw_traceback(dirs: torch.Tensor, score: torch.Tensor, t_end: torch.Tensor,
                 q_end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dirs (B, Q, T) u8 and score/t_end/q_end (B,) i32 -> (runs_op,
    runs_len (RLE_M, B) i32, meta (8, B) i32). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_inputs("sw_traceback", dirs, score, t_end, q_end)
    if dirs.device.type == "cpu":
        return sw_traceback_plain(dirs, score, t_end, q_end)
    from .cuda_build import load_kernels

    B = dirs.shape[0]
    runs = torch.empty((2, RLE_M, B), dtype=torch.int32, device=dirs.device)
    meta = torch.empty((8, B), dtype=torch.int32, device=dirs.device)
    _launch("sw_traceback", load_kernels().sw_traceback_launch, dirs, score, t_end, q_end,
            (runs[0], runs[1], meta))
    return runs[0], runs[1], meta


def sw_traceback_packed(dirs: torch.Tensor, score: torch.Tensor, t_end: torch.Tensor,
                        q_end: torch.Tensor) -> torch.Tensor:
    """The same walk -> the packed (OUT_ROWS, B) u8 transfer buffer. CPU
    tensors take `sw_traceback_packed_plain`; CUDA tensors launch the
    kernel's packed epilogue, and nothing runs after it."""
    _check_inputs("sw_traceback_packed", dirs, score, t_end, q_end)
    if dirs.device.type == "cpu":
        return sw_traceback_packed_plain(dirs, score, t_end, q_end)
    from .cuda_build import load_kernels

    out = torch.empty((OUT_ROWS, dirs.shape[0]), dtype=torch.uint8, device=dirs.device)
    _launch("sw_traceback_packed", load_kernels().sw_traceback_packed_launch, dirs, score,
            t_end, q_end, (out,))
    return out


def pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta) -> torch.Tensor:
    """Pack the walker's runs and coordinates into the u8 transfer
    buffer. Runs stay at their descending slots: rows [M - n_runs, M)
    hold the forward-order cigar."""

    def u16rows(v):
        v = v.to(torch.int32)
        return torch.stack([v & 0xFF, (v >> 8) & 0xFF])

    n_runs = meta[3]
    nr = torch.where(n_runs > RLE_M, 0xFFFF, n_runs)
    return torch.cat([
        runs_len & 0xFF,
        (runs_op << 5) | ((runs_len >> 8) & 0x1F),
        u16rows(score),
        u16rows(t_end),
        u16rows(q_end),
        u16rows(meta[0]),  # t_begin
        u16rows(meta[1]),  # q_begin
        u16rows(meta[2]),  # edits
        u16rows(nr),
    ]).to(torch.uint8)


def sw_traceback_packed_plain(dirs: torch.Tensor, score: torch.Tensor, t_end: torch.Tensor,
                              q_end: torch.Tensor) -> torch.Tensor:
    """`pack_rle_output` over `sw_traceback_plain`."""
    runs_op, runs_len, meta = sw_traceback_plain(dirs, score, t_end, q_end)
    return pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta)


def sw_traceback_plain(dirs: torch.Tensor, score: torch.Tensor, t_end: torch.Tensor,
                       q_end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same walk in plain torch ops, every live walker one step per
    iteration (a walk takes at most Q+T-1 steps)."""
    B, Q, T = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    flat = dirs.reshape(B, Q * T)
    cols = torch.arange(B, device=dev)
    slot = torch.arange(RLE_M, dtype=i32, device=dev)[:, None]
    zero = torch.zeros(B, dtype=i32, device=dev)

    t = t_end.to(i32)
    q = q_end.to(i32)
    layer = torch.where(score > 0, _H, _DONE).to(i32)
    edits = cur_op = cur_len = nrun = fin_t = fin_q = fin_e = zero
    runs_op = torch.zeros((RLE_M, B), dtype=i32, device=dev)
    runs_len = torch.zeros((RLE_M, B), dtype=i32, device=dev)

    for step in range(Q + T - 1):
        if step % 16 == 0 and not bool((layer != _DONE).any()):
            break
        live = layer != _DONE
        cell_idx = q.clamp(0, Q - 1).long() * T + t.clamp(0, T - 1).long()
        cell = flat[cols, cell_idx].to(i32)
        h_src = cell & 3
        e_ext = (cell >> 2) & 1
        f_ext = (cell >> 3) & 1
        is_match = ((cell >> 4) & 1) == 1

        in_h = live & (layer == _H)
        stop = in_h & (h_src == 0)
        do_m = in_h & (h_src == 1)
        do_i = (in_h & (h_src == 2)) | (live & (layer == _E))
        do_d = (in_h & (h_src == 3)) | (live & (layer == _F))
        op = torch.where(do_m, torch.where(is_match, OP_EQ, OP_X),
                         torch.where(do_i, OP_I, torch.where(do_d, OP_D, 0))).to(i32)

        # close the current run when the op changes
        has_op = op > 0
        change = has_op & (op != cur_op)
        emit = change & (cur_op > 0)
        sel = emit[None, :] & (slot == (RLE_M - 1 - nrun)[None, :])
        runs_op = torch.where(sel, cur_op[None, :], runs_op)
        runs_len = torch.where(sel, cur_len[None, :], runs_len)
        nrun = nrun + emit.to(i32)
        cur_op = torch.where(change, op, cur_op)
        cur_len = torch.where(change, 1, cur_len + has_op.to(i32)).to(i32)
        edits = edits + (has_op & (op != OP_EQ)).to(i32)

        new_t = t - (do_m | do_d).to(i32)
        new_q = q - (do_m | do_i).to(i32)
        new_layer = torch.where(do_m, _H, torch.where(
            do_i, torch.where(e_ext == 1, _E, _H),
            torch.where(f_ext == 1, _F, _H))).to(i32)
        off = ~stop & ((new_t < 0) | (new_q < 0))
        finish = live & (stop | off)
        # flush the run in progress when the walk ends
        flush = finish & (cur_op > 0)
        sel = flush[None, :] & (slot == (RLE_M - 1 - nrun)[None, :])
        runs_op = torch.where(sel, cur_op[None, :], runs_op)
        runs_len = torch.where(sel, cur_len[None, :], runs_len)
        nrun = nrun + flush.to(i32)
        cur_op = torch.where(finish, 0, cur_op).to(i32)

        fin_t = torch.where(finish, torch.where(stop, t + 1, new_t + 1), fin_t)
        fin_q = torch.where(finish, torch.where(stop, q + 1, new_q + 1), fin_q)
        fin_e = torch.where(finish, edits, fin_e)
        moved = live & ~finish
        t = torch.where(moved, new_t, t)
        q = torch.where(moved, new_q, q)
        layer = torch.where(finish, _DONE, torch.where(live, new_layer, layer)).to(i32)

    meta = torch.stack([fin_t, fin_q, fin_e, nrun] + [zero] * 4)
    return runs_op, runs_len, meta
