"""Fused device-side batched extension: unpack the q2 upload, run the
Smith-Waterman forward kernel and the traceback kernel, pack the compact
host output.

Counterpart of rabbitsalign_tpu/ops/extend_device.py; the glue around
the two kernels (unpack_q2, _pack_rle_output) is torch ops, as it was
XLA ops there. The transfer formats are the engine's and are unchanged:

  input  q2 (ceil(Q/4) + ceil(Q/8) + 8, B) u8: 2-bit query codes
         (4 per byte), an N-mask bitmap, then qlen u16, tlen u16 and the
         target's u32 offset into the concatenated reference
         (engine.cpp chunk_fill_batch_q2);
  output (2*RLE_M + 14, B) u8: rows [0, M) run length lo byte, rows
         [M, 2M) (op << 5) | (length >> 8), then score, t_end, q_end,
         t_begin, q_begin, edits and n_runs as u16 (lo, hi) row pairs;
         n_runs 0xFFFF marks a pair with more than RLE_M runs, which the
         host re-aligns (engine.cpp chunk_set_device_results).

The reference genome stays resident on the device as one flat uint8
tensor of nt4 codes padded with REF_PAGE_OVERLAP codes 4 ('N'):
torch indexes with int64, so the 1 GiB int32-safe pages of the JAX
package are not needed. The flat copy reads the same bytes as those
pages for every target window (`pack_ref_pages` is kept for the parity
tests).
"""

from __future__ import annotations

import numpy as np
import torch

from .sw_cuda import SwParams, sw_forward
from .tb_cuda import RLE_M, sw_traceback

OUT_ROWS = 2 * RLE_M + 14

REF_PAGE_BITS = 30  # the JAX package's 1 GiB reference pages
REF_PAGE_SIZE = 1 << REF_PAGE_BITS
REF_PAGE_OVERLAP = 4096  # >= max target window (T caps at 2048)

# calls of extend_batch_packed_resident_q2 (one per dispatched batch)
calls = 0


def pack_ref_pages(codes: np.ndarray) -> np.ndarray:
    """The JAX package's paged layout: (P, PAGE + OVERLAP) overlapped
    pages so every target window [tstart, tstart+T) lives inside page
    tstart >> REF_PAGE_BITS; a sub-page genome is one page of its own
    size. Pad value 4 ('N')."""
    n = codes.shape[0]
    n_pages = max(1, -(-n // REF_PAGE_SIZE))
    width = min(REF_PAGE_SIZE, max(n, 1)) + REF_PAGE_OVERLAP
    pages = np.full((n_pages, width), 4, dtype=np.uint8)
    for p in range(n_pages):
        lo = p * REF_PAGE_SIZE
        hi = min(n, lo + width)
        pages[p, : hi - lo] = codes[lo:hi]
    return pages


def resident_ref_codes(codes: np.ndarray, device) -> torch.Tensor:
    """The flat device-resident genome: nt4 codes then REF_PAGE_OVERLAP
    codes 4, so a window read past the genome's end reads 'N'."""
    flat = np.full(codes.shape[0] + REF_PAGE_OVERLAP, 4, dtype=np.uint8)
    flat[: codes.shape[0]] = codes
    return torch.from_numpy(flat).to(device)


def unpack_q2(buf: torch.Tensor, ref_codes: torch.Tensor, Q: int, T: int):
    """Decode the q2 upload into (q_t (Q, B) u8, t_t (T, B) u8, qlen (B,)
    i32, tlen (B,) i32): query N and rows past qlen become code 4, and
    each target window is gathered from the flat resident genome with the
    clamp min(tstart + row, len - 1) and code 4 past tlen."""
    Qp = (Q + 3) // 4
    Qm = (Q + 7) // 8
    dev = buf.device
    packed = buf[:Qp].to(torch.int32)
    nmask = buf[Qp : Qp + Qm].to(torch.int32)
    tail = buf[Qp + Qm :].to(torch.int64)
    r = torch.arange(Q, device=dev)
    code = (packed[r >> 2] >> ((r & 3) << 1)[:, None]) & 3
    nbit = (nmask[r >> 3] >> (r & 7)[:, None]) & 1
    qlen = tail[0] | (tail[1] << 8)
    tlen = tail[2] | (tail[3] << 8)
    q_t = torch.where((nbit != 0) | (r[:, None] >= qlen[None, :]), 4, code)
    tstart = tail[4] | (tail[5] << 8) | (tail[6] << 16) | (tail[7] << 24)
    rows = torch.arange(T, device=dev)[:, None]
    ridx = torch.clamp(tstart[None, :] + rows, max=ref_codes.shape[0] - 1)
    t_t = torch.where(rows < tlen[None, :], ref_codes[ridx], 4)
    return (q_t.to(torch.uint8), t_t.to(torch.uint8), qlen.to(torch.int32),
            tlen.to(torch.int32))


def _pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta) -> torch.Tensor:
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


def unpack_output(out: np.ndarray):
    """Host-side decode of the packed output: (op_runs (M, B), len_runs
    (M, B), n_runs, score, t_end, q_end, t_begin, q_begin, edits), each
    u16 field as int32 (t_end of a score-0 pair reads 0xFFFF)."""
    M = RLE_M
    hi = out[M : 2 * M].astype(np.int32)
    op_runs = (hi >> 5).astype(np.uint8)
    len_runs = out[:M].astype(np.int32) | ((hi & 0x1F) << 8)
    vals = []
    for i in range(7):
        lo = out[2 * M + 2 * i].astype(np.int32)
        hi = out[2 * M + 2 * i + 1].astype(np.int32)
        vals.append(lo | (hi << 8))
    score, t_end, q_end, t_begin, q_begin, edits, n_runs = vals
    return (op_runs, len_runs, n_runs, score, t_end, q_end, t_begin,
            q_begin, edits)


def extend_batch_packed_resident_q2(buf: torch.Tensor, ref_codes: torch.Tensor,
                                    Q: int, T: int, params: SwParams,
                                    sub: int) -> torch.Tensor:
    """q2 upload (on the device of `ref_codes`) -> packed (OUT_ROWS, B)
    u8 output. `sub` is the per-kernel group width of the JAX package's
    signature; pairs are independent and the kernels take the whole B
    at once, so the output does not depend on it."""
    global calls
    calls += 1
    q_t, t_t, qlen, tlen = unpack_q2(buf, ref_codes, Q, T)
    score, t_end, q_end, dirs = sw_forward(q_t, t_t, qlen, tlen, params)
    runs_op, runs_len, meta = sw_traceback(dirs, score, t_end, q_end)
    return _pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta)
