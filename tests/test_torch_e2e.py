"""The port's CLI (`--device cpu`: the plain PyTorch extend) against
rabbitsalign_tpu's CLI (its device path runs the lax.scan twins on the
CPU mesh): SAM/PAF output byte-identical apart from the @PG line."""

from unittest import mock

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.ops import extend_device

from .torch_extend_cases import READ_LEN, revcomp, sim_read, write_fastq


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.RandomState(2026)
    d = tmp_path_factory.mktemp("torch_e2e")
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1 simulated\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80] + b"\n")
    se = []
    for i in range(600):
        rd = sim_read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng)
        se.append(revcomp(rd) if i % 4 == 2 else rd)
    se[7] = rng.choice(np.frombuffer(b"ACGT", np.uint8), READ_LEN).tobytes()  # unmappable
    write_fastq(d / "se.fq", se, b"s")
    r1, r2 = [], []
    for _ in range(300):
        st = rng.randint(len(genome) - 1000)
        insert = int(np.clip(rng.normal(300, 30), 200, 500))
        r1.append(sim_read(genome, st, rng))
        r2.append(revcomp(sim_read(genome, st + insert - READ_LEN, rng)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")
    return d


def _without_pg(path) -> bytes:
    return b"".join(line for line in open(path, "rb") if not line.startswith(b"@PG"))


MODES = {
    "se-sam": (["se.fq"], []),
    "pe-sam": (["r1.fq", "r2.fq"], []),
    "se-paf": (["se.fq"], ["-x"]),
    "pe-no-tpu": (["r1.fq", "r2.fq"], ["--no-tpu"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_output_matches_jax(data, mode):
    reads, extra = MODES[mode]
    argv = [str(data / "ref.fa"), *(str(data / r) for r in reads), "-t", "1",
            "--tpu-batch", "64", *extra]
    assert jax_main(argv + ["-o", str(data / f"{mode}.jax.out")]) == 0
    calls = extend_device.calls
    assert port_main(argv + ["--device", "cpu", "-o", str(data / f"{mode}.port.out")]) == 0
    port_out = _without_pg(data / f"{mode}.port.out")
    assert port_out == _without_pg(data / f"{mode}.jax.out")
    assert len(port_out.splitlines()) >= 590  # PAF leaves out unmapped reads
    if mode.endswith("-sam"):
        # batches of >= 48 jobs went through the port's device extend
        assert extend_device.calls > calls


def test_prebuilt_index_matches_jax(data, tmp_path):
    """An index written by the port's -i, mapped with --use-index by both."""
    ref = tmp_path / "ref.fa"
    ref.write_bytes((data / "ref.fa").read_bytes())
    assert port_main([str(ref), "-i", "-r", "150"]) == 0
    argv = [str(ref), str(data / "se.fq"), "--use-index", "-t", "1", "--tpu-batch", "64"]
    assert jax_main(argv + ["-o", str(tmp_path / "jax.sam")]) == 0
    assert port_main(argv + ["--device", "cpu", "-o", str(tmp_path / "port.sam")]) == 0
    assert _without_pg(tmp_path / "port.sam") == _without_pg(tmp_path / "jax.sam")


THREAD_MODES = {
    "se-default-t": (["se.fq"], []),
    "pe-deterministic-t3": (["r1.fq", "r2.fq"], ["--deterministic", "-t", "3"]),
}


@pytest.mark.parametrize("mode", list(THREAD_MODES))
def test_cli_threads_match_jax(data, mode):
    """The default run (-t 3 workers) and deterministic 3-worker PE, with
    the same flags on both CLIs."""
    reads, extra = THREAD_MODES[mode]
    argv = [str(data / "ref.fa"), *(str(data / r) for r in reads), "--tpu-batch", "64", *extra]
    assert jax_main(argv + ["-o", str(data / f"{mode}.jax.out")]) == 0
    calls = extend_device.calls
    assert port_main(argv + ["--device", "cpu", "-o", str(data / f"{mode}.port.out")]) == 0
    assert extend_device.calls > calls
    port_out = _without_pg(data / f"{mode}.port.out")
    assert port_out == _without_pg(data / f"{mode}.jax.out")
    assert len(port_out.splitlines()) >= 600


@pytest.mark.parametrize("mmap", [False, True], ids=["first-run-builds", "sidecar-from-i"])
def test_mmap_index_matches_jax(data, tmp_path, mmap):
    """--use-index --mmap-index: the first run without a sidecar reads the
    .sti and builds the sidecar; with the sidecar -i wrote, the index opens
    as memmaps. Either way the SAM equals the JAX CLI's."""
    ref = tmp_path / "ref.fa"
    ref.write_bytes((data / "ref.fa").read_bytes())
    assert port_main([str(ref), "-i", "-r", "150", *([] if mmap else ["--no-sidecar"])]) == 0
    cols = tmp_path / "ref.fa.r150.sti.cols"
    assert cols.is_dir() == mmap
    argv = [str(ref), str(data / "se.fq"), "--use-index", "-t", "1", "--tpu-batch", "64"]
    assert jax_main(argv + ["-o", str(tmp_path / "jax.sam")]) == 0
    assert port_main(argv + ["--mmap-index", "--device", "cpu", "-o",
                             str(tmp_path / "port.sam")]) == 0
    assert (cols / "header.json").is_file()
    assert _without_pg(tmp_path / "port.sam") == _without_pg(tmp_path / "jax.sam")


def test_profile_writes_a_trace(data, tmp_path):
    """--profile DIR on --device cpu with the default 3 workers: a Chrome
    trace in DIR holding the workers' torch ops, and the same SAM as the
    run without it."""
    import json
    import os

    argv = [str(data / "ref.fa"), str(data / "se.fq"), "--tpu-batch", "64", "--device", "cpu"]
    assert port_main(argv + ["-o", str(tmp_path / "plain.sam")]) == 0
    assert port_main(argv + ["--profile", str(tmp_path / "trace"), "-o",
                             str(tmp_path / "prof.sam")]) == 0
    assert _without_pg(tmp_path / "prof.sam") == _without_pg(tmp_path / "plain.sam")
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    op_threads = {e["tid"] for e in events if str(e.get("name", "")).startswith("aten::")}
    assert op_threads - {os.getpid()}  # ops from the worker threads


# on cuda without a card --shard-index is refused as the extend is (with
# --no-tpu by the shard mesh)
@pytest.mark.parametrize("flags,message", [
    (["--device-seed", "--shard-index"], "no CUDA device"),
    (["--shard-index"], "no CUDA device"),
    (["--shard-index", "--no-tpu"], "no CUDA device"),
], ids=["device-seed", "shard-index", "shard-index-no-tpu"])
def test_unported_options_are_refused(data, flags, message, capsys):
    import torch

    if message == "no CUDA device" and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert port_main([str(data / "ref.fa"), str(data / "se.fq"), *flags]) == 1
    assert message in capsys.readouterr().err


def test_cuda_device_without_gpu_is_refused(data, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert port_main([str(data / "ref.fa"), str(data / "se.fq"), "-t", "1",
                      "-o", str(data / "nogpu.sam")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_pipeline_map_all_matches_jax(data):
    """NativePipeline.map_all (records in, the two-phase API) over an index
    built from the JAX package's arrays: the port's device path on the CPU
    against the JAX package's, chunk by chunk, small batches dispatched."""
    from rabbitsalign_tpu.align.aligner import AlignmentParameters as JaxAlnParams
    from rabbitsalign_tpu.index.params import IndexParameters as JaxIndexParameters
    from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex as JaxIndex
    from rabbitsalign_tpu.io.fasta import References as JaxReferences
    from rabbitsalign_tpu.io.fastq import InputBuffer
    from rabbitsalign_tpu.map.common import MappingParameters as JaxMapParams
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline as JaxPipeline
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References
    from rabbitsalign_tpu_torch.map.common import MappingParameters
    from rabbitsalign_tpu_torch.pipeline.native_pipeline import NativePipeline

    ref = str(data / "ref.fa")
    jax_refs = JaxReferences.from_fasta(ref)
    jax_index = JaxIndex(jax_refs, JaxIndexParameters.from_read_length(150))
    jax_index.populate(0.0002)
    refs = References.from_fasta(ref)
    index = StrobemerIndex.from_jax_arrays(
        refs, IndexParameters.from_read_length(150), jax_index.hashes,
        jax_index.positions, jax_index.packed, jax_index.randstrobe_start_indices,
        jax_index.filter_cutoff, jax_index.bits)
    chunks = list(InputBuffer(str(data / "r1.fq"), str(data / "r2.fq"), 100).chunks())

    jax_mp = JaxMapParams(r=150)
    jax_mp.rescue_cutoff = 2 * jax_index.filter_cutoff
    jax_pipe = JaxPipeline(jax_index, jax_index.parameters, jax_refs, JaxAlnParams(), jax_mp,
                           use_device=True, batch_size=32)
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff)
    port_pipe = NativePipeline(index, index.parameters, refs, AlignmentParameters(), mp,
                               use_device=True, batch_size=32, device="cpu")
    for pipe in (jax_pipe, port_pipe):
        pipe.engine.MIN_DEVICE_JOBS = 8
    jax_out, port_out = [], []
    calls = extend_device.calls
    assert jax_pipe.map_all(iter(chunks), jax_out.append) == 600
    assert port_pipe.map_all(iter(chunks), port_out.append) == 600
    assert extend_device.calls > calls + 2
    assert port_out == jax_out


# -- RABBITSALIGN_TPU_NO_NATIVE: the Python mapper ---------------------------

NO_NATIVE = "RABBITSALIGN_TPU_NO_NATIVE"


@pytest.fixture(scope="module")
def small(data, tmp_path_factory):
    """A smaller input for the Python mapper, whose host SSW takes a tenth
    of a second a gapped job: 90 SE reads (a sixth with an indel, a quarter
    reverse-complemented, one unrelated) and 60 pairs on data's genome,
    and the genome indexed by the port's -i for --use-index."""
    d = tmp_path_factory.mktemp("torch_no_native")
    genome = b"".join(line.strip() for line in open(data / "ref.fa", "rb")
                      if not line.startswith(b">"))
    rng = np.random.RandomState(15)

    def read(st, i):
        rd = bytearray(genome[st:st + READ_LEN])
        for _ in range(rng.randint(3)):
            rd[rng.randint(READ_LEN)] = b"ACGT"[rng.randint(4)]
        if i % 6 == 1:
            cut = rng.randint(40, 100)
            rd = rd[:cut] + genome[st + cut + 3:st + READ_LEN + 3]
        return bytes(rd)

    se = [read(rng.randint(len(genome) - 2 * READ_LEN), i) for i in range(90)]
    se = [revcomp(rd) if i % 4 == 2 else rd for i, rd in enumerate(se)]
    se[5] = rng.choice(np.frombuffer(b"ACGT", np.uint8), READ_LEN).tobytes()
    write_fastq(d / "se.fq", se, b"s")
    r1, r2 = [], []
    for i in range(60):
        st = rng.randint(len(genome) - 1000)
        insert = int(np.clip(rng.normal(300, 30), 200, 500))
        r1.append(read(st, i))
        r2.append(revcomp(read(st + insert - READ_LEN, i + 3)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")
    (d / "ref.fa").write_bytes((data / "ref.fa").read_bytes())
    assert port_main([str(d / "ref.fa"), "-i", "-r", "150", "--no-sidecar"]) == 0
    return d


@pytest.fixture
def no_native(monkeypatch):
    """RABBITSALIGN_TPU_NO_NATIVE set for both packages: the port reads it
    at every call; the JAX package caches its library and whether it
    tried, so both are reset here and restored after the test. Torch runs
    on one thread meanwhile: the plain extends of 64 pairs gain nothing
    from more, which would only crowd the other test workers' cores."""
    import torch

    from rabbitsalign_tpu import native as jnative

    monkeypatch.setenv(NO_NATIVE, "1")
    monkeypatch.setattr(jnative, "_tried", False)
    monkeypatch.setattr(jnative, "_lib", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NO_NATIVE_MODES = {
    "se-sam": (["se.fq"], []),
    "pe-sam": (["r1.fq", "r2.fq"], []),
    "se-paf": (["se.fq"], ["-x"]),
    "pe-paf": (["r1.fq", "r2.fq"], ["-x"]),
    "se-use-index": (["se.fq"], ["--use-index"]),
}


@pytest.mark.parametrize("mode", list(NO_NATIVE_MODES))
def test_no_native_cli_matches_jax(small, no_native, mode, capsys):
    """Under RABBITSALIGN_TPU_NO_NATIVE both CLIs map with the Python
    mapper: the port with --device cpu (the BatchAligner on the kernels'
    plain versions) and with --no-tpu (the host SSW) against the JAX CLI
    with --no-tpu (its BatchAligner needs a TPU), apart from @PG."""
    from rabbitsalign_tpu import native as jnative
    from rabbitsalign_tpu_torch import native

    reads, extra = NO_NATIVE_MODES[mode]
    argv = [str(small / "ref.fa"), *(str(small / r) for r in reads), "--chunk-size", "50",
            "--tpu-batch", "64", *extra]
    assert jax_main(argv + ["--no-tpu", "-o", str(small / f"{mode}.jax")]) == 0
    assert jnative._tried and jnative._lib is None  # the JAX run had no library
    want = _without_pg(small / f"{mode}.jax")
    calls = extend_device.packed_calls
    with mock.patch.object(native, "load_engine", side_effect=AssertionError("engine used")):
        assert port_main(argv + ["--device", "cpu", "-o", str(small / f"{mode}.cpu")]) == 0
        assert port_main(argv + ["--no-tpu", "-o", str(small / f"{mode}.host")]) == 0
    assert _without_pg(small / f"{mode}.cpu") == want
    assert _without_pg(small / f"{mode}.host") == want
    n_lines = 90 if mode.startswith("se") else 120
    assert len(want.splitlines()) >= n_lines - (5 if "paf" in mode else 0)
    err = capsys.readouterr().err
    assert "-t do not apply" in err
    if "paf" not in mode:
        assert extend_device.packed_calls > calls
        assert "Device extend:" in err


def test_no_native_refuses_a_pod(small, no_native, capsys):
    argv = [str(small / "ref.fa"), str(small / "se.fq"), "--device", "cpu", "--num-nodes", "2",
            "--coordinator", "127.0.0.1:1", "-o", str(small / "pod.sam")]
    assert port_main(argv) == 1
    assert f"--num-nodes > 1 requires the native engine, which {NO_NATIVE} turns off" in \
        capsys.readouterr().err


def test_failed_engine_build_raises_and_names_the_variable(small, monkeypatch, tmp_path,
                                                          capsys):
    """Without the variable an engine that does not build fails the run,
    and the message says how to take the Python mapper; nothing falls
    back by itself."""
    from rabbitsalign_tpu_torch import native

    monkeypatch.setenv("RABBITSALIGN_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "GXX_FLAGS", (*native.GXX_FLAGS, "--no-such-flag"))
    with pytest.raises(RuntimeError, match=f"set {NO_NATIVE}=1 to map with the Python mapper"):
        native.load_engine()
    argv = [str(small / "ref.fa"), str(small / "se.fq"), "--device", "cpu", "-t", "1",
            "--tpu-batch", "64", "-o", str(small / "nobuild.sam")]
    assert port_main(argv) == 1
    err = capsys.readouterr().err
    assert "native engine build failed" in err and NO_NATIVE in err
    monkeypatch.setenv(NO_NATIVE, "1")
    with pytest.raises(RuntimeError, match=f"turned off by {NO_NATIVE}"):
        native.load_engine()
    assert port_main(argv) == 0
