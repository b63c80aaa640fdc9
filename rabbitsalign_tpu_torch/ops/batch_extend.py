"""BatchAligner: collect gapped-extension jobs, run them on the device
in fixed-shape buckets, return SSW-compatible AlignmentInfo results.

The Python mapper's counterpart of the reference's GPU bridge
(reference src/gasal2_ssw.cpp solve_ssw_on_gpu + Aligner::align_gpu
post-processing), and the port of rabbitsalign_tpu/ops/batch_extend.py:
jobs are padded into (Q, T) buckets, uploaded in the self-contained
(Q + T + 4, B) layout, run through the forward and traceback kernels
(ops/extend_device.py:extend_batch_packed), and finished on the host
with the same '='/'X' cigars, soft clips and end-bonus extension as the
host Aligner. A job that does not fit a bucket is aligned on the host;
one that scores zero gets the host aligner's failure values; a cigar
that does not span its ends is redone with the host aligner and counted
in `n_fallbacks` — the analog of the reference's `gasal_fail` CPU
fallback (reference src/pc.cpp:446-478).

Dispatch is asynchronous: every batch is uploaded and its kernels are
enqueued on the current stream before any result is copied back, so the
device extends one chunk while the host runs the next chunk's phase A.
On ``device="cpu"`` the kernels' plain PyTorch versions run instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..align.aligner import Aligner, AlignmentParameters
from ..align.hamming import AlignmentInfo
from ..utils.dna import encode
from .extend_device import extend_batch_packed, ops_to_cigars, pack_input, unpack_output
from .sw_cuda import SwParams

# (Q, T, max batch) buckets; a job uses the smallest bucket that fits —
# the legacy buckets of native/engine.py ENGINE_BUCKETS, so the kernels
# run at the shapes the engine's path already runs.
# extend_seed windows are read+|diff|+100; rescue windows reach mu+5*sigma
# + read/2 (~1100 for the initial prior); the reference caps targets at
# 2000 (src/gasal2_ssw.h:24-25, src/aligner.cpp:118).
DEFAULT_BUCKETS: Tuple[Tuple[int, int, int], ...] = (
    (256, 512, 512),
    (256, 1536, 512),
    (512, 2048, 512),
)


@dataclasses.dataclass
class _Job:
    query: bytes
    ref: bytes


class BatchAligner:
    def __init__(
        self,
        parameters: AlignmentParameters,
        batch_size: int = 512,
        buckets: Tuple[Tuple[int, int, int], ...] = DEFAULT_BUCKETS,
        golden_check: bool = False,
        device="cuda",
    ):
        self.parameters = parameters
        self.sw_params = SwParams(
            parameters.match, parameters.mismatch, parameters.gap_open, parameters.gap_extend
        )
        self.batch_size = batch_size
        self.buckets = buckets
        self.golden_check = golden_check
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchAligner: no CUDA device (pass device='cpu' for the "
                               "kernels' plain versions)")
        self.host_aligner = Aligner(parameters)
        self.jobs: List[_Job] = []
        self.n_fallbacks = 0
        self.n_device_jobs = 0
        self.n_host_jobs = 0  # refused by every bucket, aligned on the host

    def submit(self, query: bytes, ref: bytes) -> int:
        """Queue a gapped alignment; returns its job index."""
        self.jobs.append(_Job(query, ref))
        return len(self.jobs) - 1

    def __len__(self) -> int:
        return len(self.jobs)

    def _bucket_for(self, job: _Job) -> Optional[Tuple[int, int, int]]:
        if len(job.ref) > 2000:
            return None  # refused, like Aligner::align
        for qcap, tcap, bcap in self.buckets:
            if len(job.query) <= qcap and len(job.ref) <= tcap:
                return (qcap, tcap, bcap)
        return None

    def flush(self) -> List[AlignmentInfo]:
        """Align all queued jobs; returns AlignmentInfo per job (same
        semantics as Aligner.align). Clears the queue."""
        return self.collect(self.dispatch())

    def dispatch(self):
        """Launch all queued jobs asynchronously; returns a token for
        collect(). The queue is cleared, so new jobs can be submitted while
        the device works (cross-chunk software pipelining, the analog of
        the reference's per-worker GPU thread, src/pc.cpp:938-1011)."""
        jobs = self.jobs
        self.jobs = []
        results: List[Optional[AlignmentInfo]] = [None] * len(jobs)

        # group by bucket
        grouped: Dict[Tuple[int, int, int], List[int]] = {}
        for i, job in enumerate(jobs):
            bucket = self._bucket_for(job)
            if bucket is None:
                self.n_host_jobs += 1
                results[i] = self.host_aligner.align(job.query, job.ref)
            else:
                grouped.setdefault(bucket, []).append(i)

        # upload every batch and enqueue its kernels, then fetch in order
        pending = []
        for bucket, idxs in grouped.items():
            Q, T, bcap = bucket
            B = min(self.batch_size, bcap)
            for start in range(0, len(idxs), B):
                chunk = idxs[start : start + B]
                qlen = np.zeros(B, dtype=np.int32)
                tlen = np.zeros(B, dtype=np.int32)
                q_t = np.full((Q, B), 4, dtype=np.uint8)
                t_t = np.full((T, B), 4, dtype=np.uint8)
                for col, ji in enumerate(chunk):
                    job = jobs[ji]
                    qc = encode(job.query)
                    tc = encode(job.ref)
                    q_t[: qc.shape[0], col] = qc
                    t_t[: tc.shape[0], col] = tc
                    qlen[col] = qc.shape[0]
                    tlen[col] = tc.shape[0]
                buf = torch.from_numpy(pack_input(q_t, t_t, qlen, tlen)).to(self.device)
                out_dev = extend_batch_packed(buf, Q, T, self.sw_params)  # enqueued
                pending.append((bucket, chunk, out_dev))
                self.n_device_jobs += len(chunk)

        return jobs, results, pending

    def collect(self, token) -> List[AlignmentInfo]:
        """Fetch and post-process the results of a dispatch()."""
        jobs, results, pending = token
        for (Q, T, _), chunk, out_dev in pending:
            out = out_dev.cpu().numpy()
            (op_runs, len_runs, n_runs, score, t_end, q_end, t_begin,
             q_begin, edits) = unpack_output(out)
            cigars = ops_to_cigars(op_runs, len_runs, n_runs, score)
            for col, ji in enumerate(chunk):
                job = jobs[ji]
                results[ji] = self._finish(
                    job,
                    int(score[col]),
                    int(t_begin[col]),
                    int(t_end[col]),
                    int(q_begin[col]),
                    int(q_end[col]),
                    cigars[col],
                    int(edits[col]),
                )
        return results  # type: ignore[return-value]

    def _finish(
        self,
        job: _Job,
        score: int,
        t_begin: int,
        t_end: int,
        q_begin: int,
        q_end: int,
        cigar_info,
        edits: int,
    ) -> AlignmentInfo:
        if score <= 0:
            # nothing aligned: same failure values as the host path
            aln = AlignmentInfo()
            aln.edit_distance = 100000
            aln.ref_start = 0
            aln.sw_score = -100000
            return aln
        if cigar_info is None:
            self.n_fallbacks += 1
            return self.host_aligner.align(job.query, job.ref)
        cigar, _ = cigar_info
        # validation (gasal_fail analog): cigar must span the coordinates
        span_q = sum((op_len >> 4) for op_len in cigar.ops if (op_len & 0xF) in (7, 8, 1))
        span_t = sum((op_len >> 4) for op_len in cigar.ops if (op_len & 0xF) in (7, 8, 2))
        if span_q != q_end + 1 - q_begin or span_t != t_end + 1 - t_begin:
            self.n_fallbacks += 1
            return self.host_aligner.align(job.query, job.ref)

        info = self.host_aligner.align_from_ends(
            job.query,
            job.ref,
            score,
            q_begin,
            q_end + 1,
            t_begin,
            t_end + 1,
            cigar,
            edits,
        )
        if self.golden_check:
            golden = Aligner(self.parameters).align(job.query, job.ref)
            assert golden.sw_score == info.sw_score, (golden.sw_score, info.sw_score)
        return info


class HostBatchAligner:
    """Same interface as BatchAligner, but jobs run through the host
    Aligner at collect time: the --no-tpu mode of the Python mapper.
    Both reduce to SSW semantics, and the tests hold the two to equal
    results."""

    def __init__(self, parameters: AlignmentParameters):
        self.parameters = parameters
        self.host_aligner = Aligner(parameters)
        self.jobs: List[_Job] = []
        self.n_fallbacks = 0
        self.n_device_jobs = 0

    def submit(self, query: bytes, ref: bytes) -> int:
        self.jobs.append(_Job(query, ref))
        return len(self.jobs) - 1

    def __len__(self) -> int:
        return len(self.jobs)

    def flush(self) -> List[AlignmentInfo]:
        jobs = self.jobs
        self.jobs = []
        return [self.host_aligner.align(j.query, j.ref) for j in jobs]

    def dispatch(self):
        jobs = self.jobs
        self.jobs = []
        return jobs

    def collect(self, jobs) -> List[AlignmentInfo]:
        return [self.host_aligner.align(j.query, j.ref) for j in jobs]
