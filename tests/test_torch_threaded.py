"""The port's threaded pipeline, thread boost and device prewarm against
the JAX package's, on the CPU.

The port runs with ``device="cpu"`` (its kernels' plain PyTorch
versions), the JAX package with its CPU device path (the lax.scan twins);
both with MIN_DEVICE_JOBS lowered so that small batches dispatch. SE
output does not depend on the worker count; PE output does (per-worker
insert-size state), except under ``deterministic=True``, where it is a
pure function of (input, N). Every comparison is byte for byte.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
from rabbitsalign_tpu.io.fasta import References as JaxReferences
from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
from rabbitsalign_tpu.native.engine import NativeEngine as JaxEngine
from rabbitsalign_tpu.pipeline import native_pipeline as jnp_mod
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.native.engine import NativeEngine
from rabbitsalign_tpu_torch.ops import extend_device
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from .torch_extend_cases import READ_LEN, mixed_pairs, q2_batch, revcomp, sim_read, write_fastq

CHUNK = 64  # reads per chunk: several chunks per worker


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 150 kbp genome, 400 SE reads and 250 PE pairs, and one index
    (built by the JAX package, loaded into the port from its arrays)."""
    rng = np.random.RandomState(77)
    d = tmp_path_factory.mktemp("torch_threaded")
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150_000).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1\n" + genome + b"\n")
    se = [sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng) for _ in range(400)]
    write_fastq(d / "se.fq", [revcomp(r) if i % 3 == 1 else r for i, r in enumerate(se)], b"s")
    r1, r2 = [], []
    for _ in range(250):
        st = rng.randint(len(genome) - 1000)
        insert = int(np.clip(rng.normal(300, 30), 200, 500))
        r1.append(sim_read(genome, st, rng))
        r2.append(revcomp(sim_read(genome, st + insert - READ_LEN, rng)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")

    ref = str(d / "ref.fa")
    jax_refs = JaxReferences.from_fasta(ref)
    jax_index = JaxIndex(jax_refs, JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    refs = References.from_fasta(ref)
    index = StrobemerIndex.from_jax_arrays(
        refs, IndexParameters.from_read_length(150), jax_index.hashes,
        jax_index.positions, jax_index.packed, jax_index.randstrobe_start_indices,
        jax_index.filter_cutoff, jax_index.bits)
    return d, jax_refs, jax_index, refs, index


@pytest.fixture
def small_batches(monkeypatch):
    monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", 8)
    monkeypatch.setattr(JaxEngine, "MIN_DEVICE_JOBS", 8)


def _inputs(world, pe):
    d = world[0]
    return (str(d / "r1.fq"), str(d / "r2.fq")) if pe else (str(d / "se.fq"), "")


def _port(world, n_workers=None, pe=False, **kw):
    """Map with the port: the sequential NativePipeline when n_workers is
    None, else ThreadedNativePipeline. Returns (n_reads, bytes, pipe)."""
    _, _, _, refs, index = world
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff)
    args = (index, index.parameters, refs, AlignmentParameters(), mp)
    if n_workers is None:
        pipe = pnp.NativePipeline(*args, use_device=True, batch_size=32, device="cpu")
    else:
        pipe = pnp.ThreadedNativePipeline(*args, use_device=True, batch_size=32,
                                          n_workers=n_workers, device="cpu", **kw)
    out = []
    n = pipe.map_file(*_inputs(world, pe), False, CHUNK, out.append)
    return n, b"".join(out), pipe


def _jax(world, n_workers=None, pe=False, **kw):
    _, jax_refs, jax_index, _, _ = world
    mp = JaxMapParams(r=150)
    mp.rescue_cutoff = 2 * jax_index.filter_cutoff
    args = (jax_index, jax_index.parameters, jax_refs, JaxAlnParams(), mp)
    if n_workers is None:
        pipe = jnp_mod.NativePipeline(*args, use_device=True, batch_size=32)
    else:
        pipe = jnp_mod.ThreadedNativePipeline(*args, use_device=True, batch_size=32,
                                              n_workers=n_workers, **kw)
    out = []
    pipe.map_file(*_inputs(world, pe), False, CHUNK, out.append)
    return b"".join(out)


@pytest.mark.parametrize("n_workers", [1, 3])
def test_se_threaded_matches_jax(world, small_batches, n_workers):
    """SE bytes equal the JAX package's sequential and 3-worker pipelines,
    and the extend batches went through the port's device path."""
    calls = extend_device.calls
    n, port_out, _ = _port(world, n_workers)
    assert n == 400
    assert extend_device.calls > calls + 2
    jax_seq = _jax(world)
    assert port_out == jax_seq
    assert port_out == _jax(world, 3)
    assert len(port_out.splitlines()) >= 400


def test_pe_deterministic_matches_jax(world, small_batches):
    """Deterministic 3-worker PE equals the JAX package's and repeats
    byte for byte; one deterministic worker equals the sequential run."""
    n, a, _ = _port(world, 3, pe=True, deterministic=True)
    assert n == 500
    assert a == _jax(world, 3, pe=True, deterministic=True)
    assert a == _port(world, 3, pe=True, deterministic=True)[1]
    assert _port(world, 1, pe=True, deterministic=True)[1] == _port(world, pe=True)[1]


def test_pe_threaded_record_count_and_order(world, small_batches):
    """Non-deterministic PE: every read once, primaries in input order."""
    n, out, _ = _port(world, 3, pe=True)
    assert n == 500
    lines = out.decode().splitlines()
    assert len(lines) == 500
    names = [ln.split("\t")[0] for ln in lines if not int(ln.split("\t")[1]) & 0x100]
    assert names == [f"p{i}" for i in range(250) for _ in (0, 1)]


def test_pin_workers(world):
    allowed = sorted(os.sched_getaffinity(0))
    n, out, pipe = _port(world, 3, pin_workers=True)
    assert n == 400 and out == _port(world)[1]
    assert sorted(pipe.pinned_cpus) == [(w, allowed[w % len(allowed)]) for w in range(3)]
    # pinning happens on the worker threads: the caller's mask is unchanged
    assert sorted(os.sched_getaffinity(0)) == allowed


def test_genome_uploaded_once_for_all_workers(world, small_batches, monkeypatch):
    uploads = []

    def counting(codes, device):
        uploads.append(device)
        return extend_device.resident_ref_codes(codes, device)

    monkeypatch.setattr(pnp, "resident_ref_codes", counting)
    assert _port(world, 3)[0] == 400
    assert len(uploads) == 1


def test_worker_error_raises_instead_of_hanging(world, monkeypatch):
    """A worker whose phase A raises makes map_file raise, in bounded
    time, for both hand-out modes."""
    real = NativeEngine.chunk_a_fx

    def failing(self, fx, ci):
        if ci == 2:
            raise RuntimeError("phase A failed on chunk 2")
        return real(self, fx, ci)

    monkeypatch.setattr(NativeEngine, "chunk_a_fx", failing)
    for deterministic in (False, True):
        result = {}

        def run():
            try:
                _port(world, 3, deterministic=deterministic)
            except RuntimeError as e:
                result["error"] = str(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "map_file hung after a worker failed"
        assert result.get("error") == "phase A failed on chunk 2"


def test_counters_add_up_across_workers(world, small_batches):
    """Summed over workers, the engine counters and the dispatch count of
    a 3-worker SE run equal the sequential run's exactly."""
    calls = extend_device.calls
    _, _, seq = _port(world)
    seq_calls = extend_device.calls - calls
    calls = extend_device.calls
    _, _, threaded = _port(world, 3)
    assert extend_device.calls - calls == seq_calls > 2
    assert threaded.counters() == seq.counters()
    assert set(threaded.timers()) == set(seq.timers())


def test_extend_call_counter_loses_no_update(world):
    """Many threads dispatching at once with a tiny switch interval: the
    locked counter counts every call."""
    Q, T = 8, 8
    buf, genome = q2_batch(mixed_pairs(Q, T, 7, seed=1), Q, seed=1)
    buf, ref = torch.from_numpy(buf), extend_device.resident_ref_codes(genome, "cpu")
    n_threads, per_thread = 12, 40
    before = extend_device.calls
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            extend_device.extend_batch_packed_resident_q2(buf, ref, Q, T, SwParams(2, 8, 12, 1), 7)
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert extend_device.calls - before == n_threads * per_thread


@pytest.mark.parametrize("renice", ["", "0"], ids=["default", "disabled"])
def test_single_thread_map_file_boosts_its_thread(world, monkeypatch, renice):
    """map_file renices the calling thread by its native id (-5, as the
    JAX package's map_file does); RSB_RENICE=0 turns it off."""
    calls = []
    monkeypatch.setattr(os, "setpriority", lambda which, who, prio: calls.append((which, who, prio)))
    monkeypatch.setenv("RSB_RENICE", renice)
    assert _port(world)[0] == 400
    if renice == "0":
        assert calls == []
    else:
        assert calls == [(os.PRIO_PROCESS, threading.get_native_id(), -5)]


def test_prewarm_error_fails_the_run_before_output(world, monkeypatch, capsys):
    """The prewarm keeps its exception; the runner re-raises it before it
    opens the output, so no SAM is written."""
    def broken(device):
        raise RuntimeError("CUDA kernel build failed (test)")

    monkeypatch.setattr(pnp, "_warm_device", broken)
    d = world[0]
    out = d / "prewarm_fail.sam"
    assert port_main([str(d / "ref.fa"), str(d / "se.fq"), "--device", "cpu",
                      "-o", str(out)]) == 1
    assert "CUDA kernel build failed (test)" in capsys.readouterr().err
    assert not out.exists()


def test_prewarm_on_cpu_has_nothing_to_do():
    assert pnp.prewarm_device("cpu").result() is None
