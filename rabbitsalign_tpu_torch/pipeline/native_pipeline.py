"""Production chunk pipeline around the native engine, single-threaded.

Drives the two-phase schedule of the reference's async workers
(reference src/pc.cpp:1206-1510): C++ phase A of a chunk plans its
gapped-extension jobs into (Q, T) buckets; each batch is packed natively
(q2 layout), uploaded and extended on the device (ops/extend_device.py);
C++ phase B then finishes the chunk and writes its SAM/PAF bytes. Device
work is queued on the current CUDA stream and its results are copied into
pinned host memory behind a CUDA event, so phase A of the next chunks
runs while the GPU extends this one; `finish_chunk` waits on the event.

Without device extension (``--no-tpu``, or gap_extend >= gap_open) the
engine's built-in SSW resolves every gapped job on the host.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from ..native.engine import NativeEngine, NativeReader
from ..ops.extend_device import extend_batch_packed_resident_q2, resident_ref_codes
from ..ops.sw_cuda import SwParams
from ..utils.logger import logger


class NativePipeline:
    def __init__(
        self,
        index,
        index_parameters,
        references,
        aln_params,
        map_param,
        read_group_id: str = "",
        use_device: bool = True,
        batch_size: int = 1024,
        device="cuda",
        device_seed: bool = False,
        shard_index: bool = False,
    ):
        if device_seed:
            raise NotImplementedError("--device-seed is not yet ported")
        if shard_index:
            raise NotImplementedError("--shard-index is not yet ported")
        self.engine = NativeEngine(
            index, index_parameters, references, aln_params, map_param,
            read_group_id,
        )
        self.batch_size = batch_size
        if use_device and aln_params.gap_extend >= aln_params.gap_open:
            # ssw.c's striped lazy-F pruning diverges from the device
            # kernel's textbook DP exactly when gap extension is as cheap
            # as opening (O == E): host SSW keeps byte parity with the
            # reference there (E > O is rejected by the CLI already)
            logger.info(
                "gap_extend >= gap_open: device extension disabled to "
                "preserve byte-parity with the reference's ssw semantics "
                "(host SSW resolves all gapped alignments)")
            use_device = False
        self.use_device = use_device
        self.device = torch.device(device)
        if use_device:
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "--device cuda: no CUDA device is available (use "
                    "--device cpu for the plain PyTorch extend, or --no-tpu "
                    "for host alignment)")
            self._sw = SwParams(aln_params.match, aln_params.mismatch,
                                aln_params.gap_open, aln_params.gap_extend)
            # the genome stays resident on the device for the whole run
            self._ref_codes = resident_ref_codes(self.engine.ref_codes(), self.device)

    def _dispatch(self, buf: np.ndarray, Q: int, T: int, sub: int):
        """Upload one q2 batch, extend it on the device and start the copy
        of its packed output to the host. Returns (host tensor, event);
        the event is None on the CPU, where the result is ready."""
        host = torch.from_numpy(buf)
        if self.device.type != "cuda":
            return extend_batch_packed_resident_q2(
                host, self._ref_codes, Q, T, self._sw, sub), None
        dev_buf = host.pin_memory().to(self.device, non_blocking=True)
        out = extend_batch_packed_resident_q2(dev_buf, self._ref_codes, Q, T,
                                              self._sw, sub)
        out_host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        out_host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out_host, event

    def _plan_and_dispatch(self, chunk) -> list:
        pending = []
        if self.use_device and chunk.n_jobs:
            for idxs, Q, T, B, sub in self.engine.plan_batches(chunk, self.batch_size):
                buf = self.engine.fill_batch_q2(chunk, idxs, B, Q)
                out, event = self._dispatch(buf, Q, T, sub)
                pending.append((idxs, out, event, Q + T - 1))
        return pending

    # --- two-phase API (callers drive the cross-chunk pipelining) -------

    def start_chunk(self, records1, records2, records3, chunk_index: int):
        """Phase A + async device dispatch; returns an opaque state."""
        chunk = self.engine.chunk_a(records1, records2, records3, chunk_index)
        return chunk, self._plan_and_dispatch(chunk)

    def finish_chunk(self, state) -> bytes:
        """Wait for the chunk's device results, then phase B; returns the
        output bytes (SAM/PAF text is ASCII; writers are binary)."""
        chunk, pending = state
        for idxs, out, event, D in pending:
            if event is not None:
                event.synchronize()
            self.engine.set_device_results(chunk, out.numpy(), D, idxs)
        return self.engine.chunk_b_bytes(chunk)

    def map_all(
        self,
        chunks: Iterable[Tuple[int, list, list, list]],
        write: Callable[[bytes], None],
        depth: int = 3,
    ) -> int:
        """Software-pipelined mapping over (index, r1, r2, r3) chunks with
        up to `depth` chunks in flight; returns reads mapped. Phase B of
        chunk i runs after phase A of chunks i+1..i+depth, so the
        insert-size estimator trails by `depth` chunks, as the
        reference's overlapped workers do."""
        n_reads = 0
        in_flight = deque()
        for chunk_index, r1, r2, r3 in chunks:
            n_reads += len(r1) + len(r2) + len(r3)
            in_flight.append(self.start_chunk(r1, r2, r3, chunk_index))
            if len(in_flight) > depth:
                write(self.finish_chunk(in_flight.popleft()))
        while in_flight:
            write(self.finish_chunk(in_flight.popleft()))
        return n_reads

    def map_file(self, path1, path2, interleaved, chunk_size, write,
                 depth: int = 3, progress=None) -> int:
        """Fully native input path: the C++ reader parses chunks, phase A
        consumes them zero-copy, the device extends, phase B writes
        output. Returns the number of reads mapped. `progress(n_reads)`
        is called after every chunk when given."""
        reader = NativeReader(path1, path2, interleaved, chunk_size)
        n_reads = 0
        in_flight = deque()
        try:
            for chunk_index, fx, n_pairs, n_singles in reader:
                n_reads += 2 * n_pairs + n_singles
                if progress is not None:
                    progress(n_reads)
                try:
                    chunk = self.engine.chunk_a_fx(fx, chunk_index)
                finally:
                    reader.free_chunk(fx)  # pooled buffer must always return
                in_flight.append((chunk, self._plan_and_dispatch(chunk)))
                if len(in_flight) > depth:
                    write(self.finish_chunk(in_flight.popleft()))
            while in_flight:
                write(self.finish_chunk(in_flight.popleft()))
        finally:
            reader.close()
        return n_reads

    def counters(self) -> dict:
        return self.engine.counters()
