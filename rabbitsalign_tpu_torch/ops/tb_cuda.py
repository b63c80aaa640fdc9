"""Traceback walk with in-walk run-length encoding: the CUDA kernel
(csrc/sw_traceback.cu) and its plain PyTorch version.

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

Outputs: runs_op / runs_len (RLE_M, B) i32 with the i-th completed run
(counted from the cigar's end) at slot RLE_M-1-i, so ascending slots read
in cigar order; meta (8, B) i32 rows [t_begin, q_begin, edits, n_runs,
0, 0, 0, 0]. Past RLE_M runs only the first RLE_M completed runs are
kept and n_runs keeps counting.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

RLE_M = 32  # run slots per pair; = engine.cpp chunk_set_device_results M

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

# launches of the CUDA kernel by sw_traceback; plain-version calls are
# not counted. Mapping workers launch from several threads, so updates
# hold _count_lock.
launches = 0
_count_lock = threading.Lock()


def sw_traceback(dirs: torch.Tensor, score: torch.Tensor, t_end: torch.Tensor,
                 q_end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dirs (B, Q, T) u8 and score/t_end/q_end (B,) i32 -> (runs_op,
    runs_len (RLE_M, B) i32, meta (8, B) i32). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    if dirs.dim() != 3 or dirs.dtype != torch.uint8:
        raise ValueError("dirs must be a (B, Q, T) uint8 tensor")
    B, Q, T = dirs.shape
    for x in (score, t_end, q_end):
        if x.shape != (B,) or x.dtype != torch.int32 or x.device != dirs.device:
            raise ValueError("score, t_end, q_end must be (B,) int32 on the dirs device")
    if dirs.device.type == "cpu":
        return sw_traceback_plain(dirs, score, t_end, q_end)
    if dirs.device.type != "cuda":
        raise ValueError(f"sw_traceback: unsupported device {dirs.device}")
    from .cuda_build import load_kernels

    lib = load_kernels()
    dirs = dirs.contiguous()
    score, t_end, q_end = score.contiguous(), t_end.contiguous(), q_end.contiguous()
    dev = dirs.device
    runs = torch.empty((2, RLE_M, B), dtype=torch.int32, device=dev)
    meta = torch.empty((8, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sw_traceback_launch(
            dirs.data_ptr(), score.data_ptr(), t_end.data_ptr(),
            q_end.data_ptr(), Q, T, B, runs[0].data_ptr(), runs[1].data_ptr(),
            meta.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sw_traceback kernel launch failed (CUDA error {err})")
    with _count_lock:
        launches += 1
    return runs[0], runs[1], meta


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
