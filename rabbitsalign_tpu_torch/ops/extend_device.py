"""Fused device-side batched extension: unpack the q2 upload, run the
Smith-Waterman forward kernel and the traceback kernel, which writes the
compact host output itself.

Counterpart of rabbitsalign_tpu/ops/extend_device.py; the glue before
the two kernels (unpack_q2) is torch ops, as it was XLA ops there, and the
pack after them (XLA ops there) is the traceback kernel's epilogue
(ops/tb_cuda.py:sw_traceback_packed; `_pack_rle_output` is its plain
version). The transfer formats are the engine's and are unchanged:

  input  q2 (ceil(Q/4) + ceil(Q/8) + 8, B) u8: 2-bit query codes
         (4 per byte), an N-mask bitmap, then qlen u16, tlen u16 and the
         target's u32 offset into the concatenated reference
         (engine.cpp chunk_fill_batch_q2);
  output (2*RLE_M + 14, B) u8: rows [0, M) run length lo byte, rows
         [M, 2M) (op << 5) | (length >> 8), then score, t_end, q_end,
         t_begin, q_begin, edits and n_runs as u16 (lo, hi) row pairs;
         n_runs 0xFFFF marks a pair with more than RLE_M runs, which the
         host re-aligns (engine.cpp chunk_set_device_results).

On a card the main path takes a batch through one native call instead,
`extend_q2_enqueue` (csrc/extend_q2.cu): the q2 upload from pinned
memory (`q2_staging`, which the engine fills in place), the forward on
the q2 layout itself (`sw_cuda.sw_forward_q2`'s kernel, which decodes the
queries and gathers the targets in its prologue), the packed traceback
and the copy of the packed rows back into the same pinned block, all on
one stream; `extend_batch_packed_resident_q2` is its composition of
separate calls, and the CPU's path.

`extend_batch_packed` is the self-contained layout of the Python
mapper's BatchAligner (ops/batch_extend.py): the input (Q + T + 4, B) u8
holds the query codes, the target codes, then qlen and tlen as u16 (lo,
hi) rows (`pack_input`, engine `fill_batch`); the output is the same
packed rows. `extend_batch_packed_grouped` is the same with the JAX
signature's group width. `extend_batch_packed_resident` takes the
query-only layout (Q + 8, B) of engine `fill_batch_q`: query codes, qlen
and tlen u16, the target's u32 offset. `extend_batch_device` returns the
forward's outputs and the traceback's unpacked runs and meta.

The reference genome stays resident on the device as one flat uint8
tensor of nt4 codes padded with REF_PAGE_OVERLAP codes 4 ('N'):
torch indexes with int64, so the 1 GiB int32-safe pages of the JAX
package are not needed. The flat copy reads the same bytes as those
pages for every target window (`pack_ref_pages` is kept for the parity
tests).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..align.cigar import CIGAR_DEL, CIGAR_EQ, CIGAR_INS, CIGAR_X, Cigar
from . import sw_cuda, tb_cuda
from .sw_cuda import SwParams, pick_dtype, sw_forward
from .tb_cuda import (OP_D, OP_EQ, OP_I, OP_NONE, OP_X, OUT_ROWS, RLE_M,  # noqa: F401
                      sw_traceback, sw_traceback_packed)
from .tb_cuda import pack_rle_output as _pack_rle_output  # noqa: F401  (the name callers use)

REF_PAGE_BITS = 30  # the JAX package's 1 GiB reference pages
REF_PAGE_SIZE = 1 << REF_PAGE_BITS
REF_PAGE_OVERLAP = 4096  # >= max target window (T caps at 2048)

# calls of extend_batch_packed_resident_q2 and extend_q2_enqueue (one per
# batch the main path dispatches), of extend_batch_packed (one per
# BatchAligner batch), and of extend_batch_packed_resident,
# extend_batch_packed_grouped and extend_batch_device; mapping workers call
# them from several threads, so updates hold _count_lock
calls = 0
packed_calls = 0
resident_calls = 0
grouped_calls = 0
device_calls = 0
_count_lock = threading.Lock()


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
    t_t = gather_targets(ref_codes, tail[4:], tlen, T)
    return q_t.to(torch.uint8), t_t, qlen.to(torch.int32), tlen.to(torch.int32)


def gather_targets(ref_codes: torch.Tensor, tstart_rows: torch.Tensor, tlen: torch.Tensor,
                   T: int) -> torch.Tensor:
    """The (T, B) u8 target windows of both resident layouts: tstart_rows
    (4, B) holds each window's u32 offset into the flat genome as bytes,
    low first; row r of window b reads ref_codes[min(tstart + r, len - 1)]
    while r < tlen, and code 4 past it."""
    t = tstart_rows.to(torch.int64)
    tstart = t[0] | (t[1] << 8) | (t[2] << 16) | (t[3] << 24)
    rows = torch.arange(T, device=tstart.device)[:, None]
    ridx = torch.clamp(tstart[None, :] + rows, max=ref_codes.shape[0] - 1)
    return torch.where(rows < tlen[None, :], ref_codes[ridx], 4).to(torch.uint8)


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
    with _count_lock:
        calls += 1
    q_t, t_t, qlen, tlen = unpack_q2(buf, ref_codes, Q, T)
    score, t_end, q_end, dirs = sw_forward(q_t, t_t, qlen, tlen, params)
    return sw_traceback_packed(dirs, score, t_end, q_end)


def q2_rows(Q: int) -> int:
    """Rows of the q2 upload at bucket Q: ceil(Q/4) code rows, ceil(Q/8)
    N-mask rows, then qlen, tlen and tstart (8 rows)."""
    return (Q + 3) // 4 + (Q + 7) // 8 + 8


def q2_staging(Q: int, B: int) -> np.ndarray:
    """The q2 upload (q2_rows(Q), B) u8 of one batch of B pairs at bucket
    Q, for the engine to fill: a view of a new pinned block of torch's
    caching host allocator that holds, after it, the (OUT_ROWS, B) packed
    rows that `extend_q2_enqueue` copies back. The view keeps the block
    alive; drop it, and the output's view, only once the batch's copy back
    has been waited for."""
    rows = q2_rows(Q)
    host = torch.empty((rows + OUT_ROWS) * B, dtype=torch.uint8, pin_memory=True)
    return host.numpy()[: rows * B].reshape(rows, B)


def enqueue_scratch_bytes(Q: int, T: int, B: int) -> int:
    """Device bytes that `extend_q2_enqueue` takes at (Q, T, B), from the
    kernel library, which lays them out (csrc/extend_q2.cu)."""
    from .cuda_build import load_kernels

    n = ctypes.c_longlong()
    if load_kernels().extend_q2_scratch_bytes(Q, T, B, ctypes.byref(n)):
        raise ValueError(f"extend_q2_enqueue: no batch of shape ({Q}, {T}, {B})")
    return n.value


def extend_q2_enqueue(q2: np.ndarray, ref_codes: torch.Tensor, Q: int, T: int,
                      params: SwParams) -> np.ndarray:
    """Enqueue one q2 batch, `q2` a `q2_staging(Q, B)` view that the engine
    filled, on the current stream of the card that holds `ref_codes` (the
    flat resident genome), in one call into the kernel library, which
    releases the GIL: the upload of `q2`, the forward on it (in the
    accumulator of `pick_dtype`), the packed traceback, and the copy of the
    packed rows into the block after `q2`. Returns that (OUT_ROWS, B) view,
    equal byte for byte to `extend_batch_packed_resident_q2`'s output once
    the copy is done: nothing is waited for, and the caller records an
    event on the stream and waits on it before reading the view. The device
    scratch is one `torch.empty` from that stream's pool."""
    global calls
    dev = ref_codes.device
    if dev.type != "cuda":
        raise ValueError(f"extend_q2_enqueue: the genome must be on a CUDA card, not {dev}")
    from .cuda_build import load_kernels

    rows, B = q2.shape
    block = q2.base
    if (rows != q2_rows(Q) or not isinstance(block, np.ndarray) or block.dtype != np.uint8
            or block.shape != ((rows + OUT_ROWS) * B,) or block.ctypes.data != q2.ctypes.data
            or ref_codes.dtype != torch.uint8 or ref_codes.dim() != 1
            or not ref_codes.is_contiguous()):
        raise ValueError(f"extend_q2_enqueue: a q2_staging({Q}, B) view and a flat uint8 "
                         f"genome expected, got {q2.shape} and {tuple(ref_codes.shape)} "
                         f"{ref_codes.dtype}")
    i16 = pick_dtype(Q, T, params) == torch.int16
    stream = torch.cuda.current_stream(dev)
    scratch = torch.empty(enqueue_scratch_bytes(Q, T, B), dtype=torch.uint8, device=dev)
    err = load_kernels().extend_q2_enqueue(
        block.ctypes.data, scratch.data_ptr(), scratch.shape[0], ref_codes.data_ptr(),
        ref_codes.shape[0], Q, T, B, *params, i16, dev.index, stream.cuda_stream)
    if err:
        raise RuntimeError(f"extend_q2_enqueue failed (CUDA error {err})")
    with _count_lock:
        calls += 1
    if B:
        sw_cuda.count_launch(i16)
        tb_cuda.count_launch()
    return block[rows * B:].reshape(OUT_ROWS, B)


def extend_batch_packed_resident(buf: torch.Tensor, ref_codes: torch.Tensor, Q: int, T: int,
                                 params: SwParams, sub: int) -> torch.Tensor:
    """The query-only upload (engine `fill_batch_q`, (Q + 8, B) u8: query
    codes, qlen u16, tlen u16, the target's u32 offset) on the device of
    `ref_codes` -> packed (OUT_ROWS, B) u8 output. The query rows go to
    the forward as they are (the fill pads them with code 4); the targets
    are gathered from the resident genome (`gather_targets`). `sub` is the
    JAX signature's group width; the kernels take the whole B at once."""
    global resident_calls
    _check_buffer("extend_batch_packed_resident", buf, Q + 8)
    with _count_lock:
        resident_calls += 1
    lens = buf[Q : Q + 4].to(torch.int32)
    qlen = lens[0] | (lens[1] << 8)
    tlen = lens[2] | (lens[3] << 8)
    t_t = gather_targets(ref_codes, buf[Q + 4 : Q + 8], tlen, T)
    score, t_end, q_end, dirs = sw_forward(buf[:Q], t_t, qlen, tlen, params)
    return sw_traceback_packed(dirs, score, t_end, q_end)


def pack_input(q_t: np.ndarray, t_t: np.ndarray, qlen: np.ndarray, tlen: np.ndarray) -> np.ndarray:
    """(Q, B) query codes, (T, B) target codes and (B,) lengths -> the
    (Q + T + 4, B) u8 input of `extend_batch_packed`."""
    Q, B = q_t.shape
    T = t_t.shape[0]
    buf = np.empty((Q + T + 4, B), dtype=np.uint8)
    buf[:Q] = q_t
    buf[Q : Q + T] = t_t
    buf[Q + T] = qlen & 0xFF
    buf[Q + T + 1] = (qlen >> 8) & 0xFF
    buf[Q + T + 2] = tlen & 0xFF
    buf[Q + T + 3] = (tlen >> 8) & 0xFF
    return buf


def extend_batch_packed(buf: torch.Tensor, Q: int, T: int, params: SwParams) -> torch.Tensor:
    """(Q + T + 4, B) u8 input (`pack_input`) -> packed (OUT_ROWS, B) u8
    output, on the device of `buf`: the forward kernel, then the
    traceback kernel whose epilogue writes the packed rows. A CPU tensor
    takes both plain versions; a CUDA tensor launches both kernels or
    raises."""
    global packed_calls
    _check_buffer("extend_batch_packed", buf, Q + T + 4)
    with _count_lock:
        packed_calls += 1
    return _extend_packed(buf, Q, T, params)


def extend_batch_packed_grouped(buf: torch.Tensor, Q: int, T: int, params: SwParams,
                                sub: int) -> torch.Tensor:
    """`extend_batch_packed` of the JAX signature that runs the kernels a
    `sub`-column group at a time. Pairs are independent, so one launch of
    each kernel over the whole B gives the same bytes, whether or not B
    is a multiple of `sub`."""
    global grouped_calls
    _check_buffer("extend_batch_packed_grouped", buf, Q + T + 4)
    if sub < 1:
        raise ValueError(f"extend_batch_packed_grouped: sub must be positive, got {sub}")
    with _count_lock:
        grouped_calls += 1
    return _extend_packed(buf, Q, T, params)


def _check_buffer(name: str, buf: torch.Tensor, rows: int) -> None:
    if buf.dim() != 2 or buf.dtype != torch.uint8 or buf.shape[0] != rows:
        raise ValueError(f"{name}: a ({rows}, B) uint8 buffer expected, "
                         f"got {tuple(buf.shape)} {buf.dtype}")


def _extend_packed(buf: torch.Tensor, Q: int, T: int, params: SwParams) -> torch.Tensor:
    lens = buf[Q + T : Q + T + 4].to(torch.int32)
    qlen = lens[0] | (lens[1] << 8)
    tlen = lens[2] | (lens[3] << 8)
    score, t_end, q_end, dirs = sw_forward(buf[:Q], buf[Q : Q + T], qlen, tlen, params)
    return sw_traceback_packed(dirs, score, t_end, q_end)


def extend_batch_device(q_t: torch.Tensor, t_t: torch.Tensor, qlen: torch.Tensor,
                        tlen: torch.Tensor, params: SwParams):
    """q_t (Q, B) u8, t_t (T, B) u8, qlen/tlen (B,) i32 -> (score, t_end,
    q_end (B,) i32, runs_op, runs_len (RLE_M, B) i32, meta (8, B) i32):
    the forward, then the traceback's runs-and-meta epilogue
    (`tb_cuda.sw_traceback`). A CPU tensor takes both plain versions; a
    CUDA tensor launches both kernels or raises."""
    global device_calls
    with _count_lock:
        device_calls += 1
    score, t_end, q_end, dirs = sw_forward(q_t, t_t, qlen, tlen, params)
    runs_op, runs_len, meta = sw_traceback(dirs, score, t_end, q_end)
    return score, t_end, q_end, runs_op, runs_len, meta


_CIGAR_OF_OP = {OP_EQ: CIGAR_EQ, OP_X: CIGAR_X, OP_I: CIGAR_INS, OP_D: CIGAR_DEL}


def ops_to_cigars(
    op_runs: np.ndarray,   # (M, B) uint8 run op codes
    len_runs: np.ndarray,  # (M, B) int32 run lengths
    n_runs: np.ndarray,    # (B,) int32; 0xFFFF = overflow
    score: np.ndarray,
) -> List[Optional[Tuple[Cigar, int]]]:
    """Decode the packed runs into =/X/I/D cigars. Runs live at slots
    [M - n_runs, M) in forward cigar order. Returns per pair (cigar,
    n_ops_consumed), or None for score <= 0, an empty walk and a pair of
    more than RLE_M runs (the caller re-aligns those on the host)."""
    B = op_runs.shape[1]
    opsT = np.ascontiguousarray(op_runs.T)
    lensT = np.ascontiguousarray(len_runs.T)
    out: List[Optional[Tuple[Cigar, int]]] = []
    for b in range(B):
        nr = int(n_runs[b])
        if score[b] <= 0 or nr == 0 or nr > RLE_M:
            out.append(None)
            continue
        cigar = Cigar()
        total = 0
        ok = True
        off = RLE_M - nr
        for r in range(off, off + nr):
            op = int(opsT[b, r])
            ln = int(lensT[b, r])
            if not 1 <= op <= 4 or ln <= 0:
                ok = False
                break
            cigar.push(_CIGAR_OF_OP[op], ln)
            total += ln
        out.append((cigar, total) if ok else None)
    return out
