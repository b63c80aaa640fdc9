"""The port's CLI (`--device cpu`: the plain PyTorch extend) against
rabbitsalign_tpu's CLI (its device path runs the lax.scan twins on the
CPU mesh): SAM/PAF output byte-identical apart from the @PG line."""

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.ops import extend_device

READ_LEN = 150
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def _read(genome: bytes, st: int, rng) -> bytes:
    """A read at `st` with 0-2 SNPs, and in two of three reads an indel
    (1-5 bp), so phase A leaves many gapped-extension jobs."""
    kind = rng.randint(3)
    if kind == 1:  # deletion
        cut, g = rng.randint(40, 100), rng.randint(1, 6)
        rd = genome[st:st + cut] + genome[st + cut + g:st + READ_LEN + g]
    elif kind == 2:  # insertion
        cut, g = rng.randint(40, 100), rng.randint(1, 5)
        ins = rng.choice(np.frombuffer(b"ACGT", np.uint8), g).tobytes()
        rd = genome[st:st + cut] + ins + genome[st + cut:st + READ_LEN - g]
    else:
        rd = genome[st:st + READ_LEN]
    rd = bytearray(rd)
    for _ in range(rng.randint(3)):
        rd[rng.randint(READ_LEN)] = b"ACGT"[rng.randint(4)]
    return bytes(rd)


def _write_fastq(path, reads, prefix):
    with open(path, "wb") as f:
        for i, rd in enumerate(reads):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, rd, b"I" * len(rd)))


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
        rd = _read(genome, rng.randint(len(genome) - 2 * READ_LEN), rng)
        se.append(_revcomp(rd) if i % 4 == 2 else rd)
    se[7] = rng.choice(np.frombuffer(b"ACGT", np.uint8), READ_LEN).tobytes()  # unmappable
    _write_fastq(d / "se.fq", se, b"s")
    r1, r2 = [], []
    for _ in range(300):
        st = rng.randint(len(genome) - 1000)
        insert = int(np.clip(rng.normal(300, 30), 200, 500))
        r1.append(_read(genome, st, rng))
        r2.append(_revcomp(_read(genome, st + insert - READ_LEN, rng)))
    _write_fastq(d / "r1.fq", r1, b"p")
    _write_fastq(d / "r2.fq", r2, b"p")
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


@pytest.mark.parametrize("flags", [
    ["-t", "2"], ["--device-seed"], ["--shard-index"],
    ["--use-index", "--mmap-index"], ["--num-nodes", "2", "-o", "out.sam"],
    ["--profile", "trace"],
], ids=["threads", "device-seed", "shard-index", "mmap-index", "num-nodes", "profile"])
def test_unported_options_are_refused(data, flags, capsys):
    assert port_main([str(data / "ref.fa"), str(data / "se.fq"), *flags]) == 1
    assert "not yet ported" in capsys.readouterr().err


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
