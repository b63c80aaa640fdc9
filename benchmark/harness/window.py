"""The measured window: the read pool, cycled, streamed through a named
pipe into `ThreadedNativePipeline.map_file`, the CLI's main path.

A feeder thread writes whole reader chunks into the pipe as fast as the
pipe takes them (a closed loop: the pipeline sets the pace, as when
`samtools fastq` pipes into the aligner) until the window's seconds are
up, then closes it; the pipeline drains. The `write` callback notes when
each chunk's records arrive (they arrive in chunk order) and keeps the
bytes of the chunks drawn for the check; it writes nothing to disk.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .trace import span

F_SETPIPE_SZ = 1031  # Linux fcntl: the pipe's buffer size


@dataclass
class WindowResult:
    start: float  # host clock at the window's start
    end: float  # host clock when the last chunk's records arrived
    n_reads: int  # reads the pipeline reports mapped
    fed_reads: int  # reads the feeder wrote
    written: List[float]  # host clock when chunk k's records arrived
    kept: Dict[int, bytes] = field(default_factory=dict)  # chunk k -> its records

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Feeder(threading.Thread):
    """Writes `chunks` in turn, cycling, into the pipe at `path` until
    `deadline` (host clock) has passed or `max_chunks` are written."""

    def __init__(self, path: str, chunks: List[bytes], deadline: float, max_chunks: int):
        super().__init__(name="bench-feeder", daemon=True)
        self.path = path
        self.chunks = chunks
        self.deadline = deadline
        self.max_chunks = max_chunks
        self.n_fed = 0  # chunks written whole
        self.error = None

    def run(self) -> None:
        try:
            fd = os.open(self.path, os.O_WRONLY)
        except OSError as e:
            self.error = e
            return
        try:
            with contextlib.suppress(OSError):
                fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
            k = 0
            while k < self.max_chunks and (k == 0 or time.perf_counter() < self.deadline):
                view = memoryview(self.chunks[k % len(self.chunks)])
                with span("feed"):
                    while view:
                        view = view[os.write(fd, view):]
                k += 1
                self.n_fed = k
        except OSError as e:  # the reader went away: the run has failed
            self.error = e
        finally:
            os.close(fd)


def _release(path: str) -> None:
    """Let a feeder blocked in open() go on, when the reader never opened
    the pipe."""
    try:
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
    except OSError as e:
        if e.errno != errno.ENXIO:
            raise
        return
    os.close(fd)


def run_window(pipeline, chunks: List[bytes], chunk_reads: int, interleaved: bool,
               chunk_size: int, seconds: float, keep=None, max_chunks: int = 1 << 30
               ) -> WindowResult:
    """Stream the chunks for `seconds` (or `max_chunks` chunks) through
    `pipeline.map_file` and wait until it has drained. `keep(k)` says
    whether chunk k's records are kept."""
    written: List[float] = []
    kept: Dict[int, bytes] = {}

    def write(text: bytes) -> None:
        with span("write"):
            k = len(written)
            written.append(time.perf_counter())
            if keep is not None and keep(k):
                kept[k] = text

    with tempfile.TemporaryDirectory(prefix="bench-fifo-") as tmp:
        path = os.path.join(tmp, "reads.fq")
        os.mkfifo(path)
        start = time.perf_counter()
        feeder = Feeder(path, chunks, start + seconds, max_chunks)
        feeder.start()
        try:
            with span("map_file"):
                n_reads = pipeline.map_file(path, "", interleaved, chunk_size, write)
        finally:
            if feeder.is_alive():
                _release(path)
            feeder.join()
    if feeder.error is not None:
        raise RuntimeError(f"the feeder stopped: {feeder.error}")
    return WindowResult(start=start, end=written[-1] if written else time.perf_counter(),
                        n_reads=n_reads, fed_reads=feeder.n_fed * chunk_reads,
                        written=written, kept=kept)


@dataclass
class ExtendJobs:
    """What the main path's extend was given, counted from each q2 batch
    (engine `fill_batch_q2`: (Qp + Qm + 8, B) u8, the lengths after the
    packed codes and the N mask) on the host before its upload: jobs,
    DP cells (query length x target window length, not the padded
    bucket) and code bytes."""

    jobs: int = 0
    cells: int = 0
    code_bytes: int = 0

    def count(self, buf: np.ndarray, Q: int) -> None:
        tail = buf[(Q + 3) // 4 + (Q + 7) // 8:].astype(np.int64)
        qlen = tail[0] | (tail[1] << 8)
        tlen = tail[2] | (tail[3] << 8)
        live = qlen > 0
        self.jobs += int(live.sum())
        self.cells += int((qlen * tlen).sum())
        self.code_bytes += int((qlen + tlen).sum())


@contextlib.contextmanager
def counting_extend_jobs(enabled: bool):
    """While `enabled`, count every batch that `NativePipeline._dispatch`
    sends to the extend; a read-only wrapper around the program's method,
    removed on exit."""
    jobs = ExtendJobs()
    if not enabled:
        yield jobs
        return
    from rabbitsalign_tpu_torch.pipeline.native_pipeline import NativePipeline

    original = NativePipeline._dispatch
    lock = threading.Lock()

    def _dispatch(self, buf, Q, T, sub):
        with lock:
            jobs.count(buf, Q)
        return original(self, buf, Q, T, sub)

    NativePipeline._dispatch = _dispatch
    try:
        yield jobs
    finally:
        NativePipeline._dispatch = original
