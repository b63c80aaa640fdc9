"""The spans and counters of the port's pipeline on the CPU: the
`rsb.*` spans in a torch.profiler trace of a 3-worker `map_file`, no
`record_function` without a profiler, the named parts of the worker
budget within the mapping threads' time, the extend counters against a
count taken from each q2 batch before its upload, the same keys for one
worker and three, and the runner's log lines."""

import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.native.engine import NativeEngine
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from .torch_extend_cases import READ_LEN, revcomp, sim_read, write_fastq

CHUNK = 64  # reads per chunk: several chunks per worker
N_SE = 400
MAIN_SPANS = {"rsb.read", "rsb.handoff"}
WORKER_SPANS = {"rsb.setup", "rsb.input_wait"}
CHUNK_SPANS = ("phase_a", "dispatch", "device_wait", "phase_b", "emit")
# the worker budget's named parts: the pipeline's timers and the engine's
NAMED_PARTS = ("worker_setup_s", "input_wait_s", "device_seed_s", "phase_a_s", "dispatch_s",
               "device_wait_s", "device_results_s", "host_align_s", "phase_b_s", "chunk_out_s",
               "emit_s")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 150 kbp genome, 400 SE reads (two in three with an indel) and
    the port's own index of it."""
    rng = np.random.RandomState(19)
    d = tmp_path_factory.mktemp("torch_spans")
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150_000).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1\n" + genome + b"\n")
    se = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(N_SE)]
    write_fastq(d / "se.fq", [revcomp(r) if i % 3 == 1 else r for i, r in enumerate(se)], b"s")
    refs = References.from_fasta(str(d / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(150))
    index.populate(0.0002)
    return d, refs, index


@pytest.fixture
def small_batches(monkeypatch):
    monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", 8)


def _map(world, n_workers=None, device_seed=False):
    """Map the SE reads on the CPU: the sequential NativePipeline when
    n_workers is None, else ThreadedNativePipeline; `device_seed` seeds
    with the kernels' plain versions. Returns (n_reads, bytes, pipe)."""
    d, refs, index = world
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff)
    args = (index, index.parameters, refs, AlignmentParameters(), mp)
    if n_workers is None:
        pipe = pnp.NativePipeline(*args, use_device=True, batch_size=32, device="cpu",
                                  device_seed=device_seed)
    else:
        pipe = pnp.ThreadedNativePipeline(*args, use_device=True, batch_size=32,
                                          n_workers=n_workers, device="cpu",
                                          device_seed=device_seed)
    out = []
    n = pipe.map_file(str(d / "se.fq"), "", False, CHUNK, out.append)
    return n, b"".join(out), pipe


def _profiled_spans(world, tmp_path, device_seed=False):
    """A 3-worker run under torch.profiler with every thread profiled:
    (name, thread id, start, end) of each `rsb.*` span, the main thread's
    id, and the pipeline."""
    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with torch.profiler.record_function("test.main"):
            n, _, pipe = _map(world, 3, device_seed)
            assert n == N_SE
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    main_tid = next(e["tid"] for e in events if e["name"] == "test.main")
    spans = [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e["name"].startswith("rsb.")]
    return spans, main_tid, pipe


def test_spans_in_the_profiler_trace(world, small_batches, tmp_path):
    """Every span of the table is in the trace: the reader's and the
    hand-off on the main thread, the rest on worker threads; each chunk
    has exactly one phase A, dispatch, phase B and emit span and a device
    wait span for each of its extend batches, and all of a chunk's spans
    sit on one worker thread."""
    spans, main_tid, pipe = _profiled_spans(world, tmp_path)
    n_batches = sum(pipe.dispatches())
    spans = [(n, tid) for n, tid, _, _ in spans]
    names = {n for n, _ in spans}
    assert MAIN_SPANS | WORKER_SPANS <= names
    assert {tid for n, tid in spans if n in MAIN_SPANS} == {main_tid}
    assert main_tid not in {tid for n, tid in spans if n in WORKER_SPANS}
    by_chunk: dict = {}
    for name, tid in spans:
        m = re.fullmatch(r"rsb\.(\w+)#(\d+)", name)
        if m:
            assert m.group(1) in CHUNK_SPANS, name
            by_chunk.setdefault(int(m.group(2)), []).append((m.group(1), tid))
    n_chunks = -(-N_SE // CHUNK)
    assert sorted(by_chunk) == list(range(n_chunks))
    for ci, found in by_chunk.items():
        kinds = [k for k, _ in found if k != "device_wait"]
        assert sorted(kinds) == sorted(set(CHUNK_SPANS) - {"device_wait"}), (ci, kinds)
        tids = {tid for _, tid in found}
        assert len(tids) == 1 and main_tid not in tids, (ci, found)
    waits = sum(k == "device_wait" for found in by_chunk.values() for k, _ in found)
    assert waits == n_batches > 0


def test_seed_span_inside_phase_a(world, tmp_path):
    """Seeding on the device (the kernels' plain versions, asked for on
    the CPU): each chunk has one `rsb.seed#c`, inside its
    `rsb.phase_a#c` on the same thread, and `device_seed_s` is the sum of
    their seconds; the default run on the CPU has none."""
    spans, _, pipe = _profiled_spans(world, tmp_path, device_seed=True)
    chunk_spans = {(n, tid): (t0, t1) for n, tid, t0, t1 in spans if "#" in n}
    seeds = [(n, tid) for n, tid in chunk_spans if n.startswith("rsb.seed#")]
    assert sorted(int(n.split("#")[1]) for n, _ in seeds) == list(range(-(-N_SE // CHUNK)))
    for name, tid in seeds:
        t0, t1 = chunk_spans[name, tid]
        a0, a1 = chunk_spans[name.replace("seed", "phase_a"), tid]
        assert a0 <= t0 <= t1 <= a1, name
    seconds = sum(t1 - t0 for t0, t1 in (chunk_spans[k] for k in seeds)) / 1e6
    assert pipe.timers()["device_seed_s"] == pytest.approx(seconds, rel=0.2)
    plain, _, _ = _profiled_spans(world, tmp_path)
    assert not any(n.startswith("rsb.seed#") for n, *_ in plain)


def test_no_record_function_without_a_profiler(world, monkeypatch):
    """Without a profiler no span enters a record_function; under one the
    same patched function is entered (so the count looks in the right
    place)."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert _map(world, 3)[0] == N_SE
    assert _map(world)[0] == N_SE
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert _map(world)[0] == N_SE
    assert {"rsb.read", "rsb.phase_a#0", "rsb.emit#0"} <= set(entered)


@pytest.mark.parametrize("n_workers", [None, 1, 3], ids=["single", "threaded-1", "threaded-3"])
def test_named_parts_within_the_mapping_threads(world, small_batches, n_workers):
    """The named parts of the worker budget add up to no more than the
    mapping threads' time, and each part the run must have is there."""
    _, _, pipe = _map(world, n_workers)
    tm = pipe.timers()
    named = sum(tm[k] for k in NAMED_PARTS)
    assert 0 < named <= tm["worker_s"]
    for key in ("phase_a_s", "dispatch_s", "phase_b_s", "chunk_out_s", "emit_s", "read_wait_s"):
        assert tm[key] > 0, key
    if n_workers is None:
        assert tm["input_wait_s"] == tm["handoff_wait_s"] == tm["worker_setup_s"] == 0
        assert tm["read_wait_s"] <= tm["worker_s"]
    else:
        assert tm["worker_setup_s"] > 0 and tm["input_wait_s"] > 0


def test_extend_counters_match_the_outside_count(world, small_batches, monkeypatch):
    """The pipeline's device_jobs and device_cells equal the live jobs and
    query x target lengths read back from each q2 batch before its upload
    (the engine's `fill_batch_q2` layout: (Qp + Qm + 8, B) u8, the
    lengths after the packed codes and the N mask), and upload_bytes the
    batches' bytes, on the same 3-worker run."""
    batches = []  # (live jobs, DP cells, bytes) a batch; appends are thread-safe
    dispatch = pnp.NativePipeline._dispatch

    def counted(self, buf, Q, T, sub):
        tail = buf[(Q + 3) // 4 + (Q + 7) // 8:].astype(np.int64)
        qlen, tlen = tail[0] | (tail[1] << 8), tail[2] | (tail[3] << 8)
        batches.append((int((qlen > 0).sum()), int((qlen * tlen).sum()), buf.nbytes))
        return dispatch(self, buf, Q, T, sub)

    monkeypatch.setattr(pnp.NativePipeline, "_dispatch", counted)
    _, _, pipe = _map(world, 3)
    jobs, cells, uploaded = (sum(col) for col in zip(*batches))
    c = pipe.counters()
    assert c["device_jobs"] == jobs > 0
    assert c["device_cells"] == cells > 0
    assert c["upload_bytes"] == uploaded > 0
    assert len(batches) == sum(pipe.dispatches())
    assert c["chunks"] == -(-N_SE // CHUNK)


def test_same_keys_for_one_worker_and_three(world, small_batches):
    """timers() and counters() have the same keys in the sequential and
    the threaded pipeline, the pipeline's own among them; in SE the
    counters are equal."""
    seq, threaded = _map(world)[2], _map(world, 3)[2]
    assert set(seq.timers()) == set(threaded.timers()) >= set(pnp.SPAN_TIMERS)
    assert set(seq.counters()) == set(threaded.counters()) >= {
        *pnp.EXTEND_COUNTERS, "small_to_host", "unbucketed", "fallbacks"}
    assert seq.counters() == threaded.counters()


def test_runner_logs_waits_and_device_extend(world, small_batches, capsys):
    """The CLI's log gains the wait line, with the workers' set-up, and
    the native path's Device extend line, with the chunks counted and no
    batch through the native enqueue, which only a card takes."""
    d = world[0]
    assert port_main([str(d / "ref.fa"), str(d / "se.fq"), "--device", "cpu", "--chunk-size",
                      str(CHUNK), "--tpu-batch", "32", "-o", str(d / "log.sam")]) == 0
    err = capsys.readouterr().err
    assert re.search(r"Phase times: .* extend dispatch [\d.]+ s, device results in [\d.]+ s, .*"
                     r"output copy and chunk release [\d.]+ s", err), err[-2000:]
    waits = re.search(r"Waits: reader [\d.]+ s, hand-off [\d.]+ s, worker set-up [\d.]+ s, "
                      r"input [\d.]+ s, device [\d.]+ s, ordered output [\d.]+ s; mapping "
                      r"threads [\d.]+ s", err)
    assert waits, err[-2000:]
    extend = re.search(r"Device extend: (\d+) jobs, (\d+) DP cells in (\d+) batches \((\d+) "
                       r"native\) of (\d+) chunks, [\d.]+ MB uploaded; on the host \d+ in small "
                       r"batches, \d+ unbucketed, \d+ rejected", err)
    assert extend and int(extend.group(1)) > 0 and int(extend.group(3)) > 0, err[-2000:]
    assert int(extend.group(4)) == 0  # the CPU takes the plain chain, never the native enqueue
    assert int(extend.group(5)) == -(-N_SE // CHUNK)
