"""`--device-seed` on the CPU (`--device cpu`: the seeding and lookup
kernels' plain PyTorch versions): the port's SAM equals its own default
run (host seeding) and rabbitsalign_tpu's CLI with `--device-seed`, SE
and PE, one mapping thread and two workers, apart from the @PG line; and
SE through `ThreadedNativePipeline` with 2 workers equals host seeding.
The reads include tandem repeats (min-queue ties) and reads longer than
the device's 256 bases, which the engine seeds on the host."""

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.ops import seed_device
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from .torch_extend_cases import READ_LEN, revcomp, sim_read, write_fastq


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.RandomState(606)
    d = tmp_path_factory.mktemp("torch_device_seed")
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150_000).tobytes()
    with open(d / "ref.fa", "wb") as f:
        f.write(b">chr1\n" + genome + b"\n")
    se = []
    for i in range(300):
        st = rng.randint(len(genome) - 400)
        if i % 25 == 3:  # longer than the device seeds
            rd = genome[st:st + 300]
        elif i % 25 == 7:  # a tandem repeat: a tie row
            rd = (bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 3)) * 60)[:READ_LEN]
        else:
            rd = sim_read(genome, st, rng)
        se.append(revcomp(rd) if i % 4 == 2 else rd)
    write_fastq(d / "se.fq", se, b"s")
    r1, r2 = [], []
    for _ in range(150):
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
    "se-t1": (["se.fq"], ["-t", "1"]),
    "pe-t1": (["r1.fq", "r2.fq"], ["-t", "1"]),
    "se-t2": (["se.fq"], ["-t", "2"]),
    "pe-deterministic-t2": (["r1.fq", "r2.fq"], ["--deterministic", "-t", "2"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_device_seed_cli_matches_default_and_jax(data, mode, monkeypatch, capsys):
    calls = []
    real = seed_device.seed_and_find
    monkeypatch.setattr(pnp, "seed_and_find", lambda *a: calls.append(1) or real(*a))
    reads, extra = MODES[mode]
    argv = [str(data / "ref.fa"), *(str(data / r) for r in reads), "--tpu-batch", "64",
            "--chunk-size", "64", *extra]
    out = {name: data / f"{mode}.{name}.sam" for name in ("default", "dseed", "jax")}
    assert port_main(argv + ["--device", "cpu", "-o", str(out["default"])]) == 0
    assert not calls
    assert port_main(argv + ["--device", "cpu", "--device-seed", "-o", str(out["dseed"])]) == 0
    assert len(calls) >= 3  # every chunk: 64 SE reads or 64 PE pairs
    log = capsys.readouterr().err
    assert "tie or long reads seeded on the host" in log
    assert jax_main(argv + ["--device-seed", "-o", str(out["jax"])]) == 0
    dseed = _without_pg(out["dseed"])
    assert dseed == _without_pg(out["default"])
    assert dseed == _without_pg(out["jax"])
    assert len(dseed.splitlines()) >= 300


def test_threaded_device_seed_matches_host_seeding(data):
    """SE through 2 workers, each seeding its chunks on the (CPU) device,
    against the sequential host-only run; the tie and long reads went to
    the engine."""
    refs = References.from_fasta(str(data / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(150))
    index.populate(0.0002)
    mp = MappingParameters(r=150, rescue_cutoff=min(2 * index.filter_cutoff, 1000))
    args = (index, index.parameters, refs, AlignmentParameters(), mp)
    golden = []
    pnp.NativePipeline(*args, use_device=False).map_file(str(data / "se.fq"), "", False, 64,
                                                         golden.append)
    out = []
    tp = pnp.ThreadedNativePipeline(*args, use_device=True, n_workers=2, device="cpu",
                                    device_seed=True)
    assert tp.map_file(str(data / "se.fq"), "", False, 64, out.append) == 300
    assert b"".join(out) == b"".join(golden)
    assert tp.counters()["host_seeded"] >= 24  # 12 long reads, 12 tandem repeats
    assert tp.timers()["device_seed_s"] > 0


def test_no_tpu_keeps_host_seeding(data, monkeypatch):
    """--device-seed needs the device path: with --no-tpu it seeds on the
    host and the device seeding is never called."""
    monkeypatch.setattr(pnp, "seed_and_find", lambda *a: pytest.fail("device seeding ran"))
    argv = [str(data / "ref.fa"), str(data / "se.fq"), "-t", "1", "--no-tpu"]
    assert port_main(argv + ["-o", str(data / "host.sam")]) == 0
    assert port_main(argv + ["--device-seed", "-o", str(data / "host-dseed.sam")]) == 0
    assert _without_pg(data / "host.sam") == _without_pg(data / "host-dseed.sam")


def test_device_seed_without_gpu_is_refused(data, capsys):
    """--device-seed --device cuda with no card fails, as the extend does,
    and does not fall back to the plain versions."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert port_main([str(data / "ref.fa"), str(data / "se.fq"), "-t", "1", "--device-seed",
                      "-o", str(data / "nogpu.sam")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("device,flag,seeds", [
    ("cuda", False, True), ("cuda:0", False, True), ("cuda", True, True),
    ("cpu", False, False), ("cpu", True, True),
])
def test_seeds_on_device_where_the_extend_runs_on_a_card(device, flag, seeds):
    """Phase A seeds on the first device of the extend's list where it is
    a CUDA card, with or without --device-seed; on the CPU only where the
    flag asks for the plain versions."""
    import torch

    assert pnp.seeds_on_device(torch.device(device), flag) is seeds


def _pipeline_args(data):
    refs = References.from_fasta(str(data / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(150))
    index.populate(0.0002)
    mp = MappingParameters(r=150, rescue_cutoff=min(2 * index.filter_cutoff, 1000))
    return index, index.parameters, refs, AlignmentParameters(), mp


HOST_SEEDING = {
    "device-cpu": {"use_device": True, "device": "cpu"},
    "no-tpu": {"use_device": False},
    "shard-index": {"use_device": True, "device": "cpu", "shard_index": True},
}


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("mode", list(HOST_SEEDING))
def test_host_seeding_off_the_card(data, mode, workers, monkeypatch):
    """With --device cpu, --no-tpu or --shard-index the engine seeds every
    record on the host: no seeding kernel or plain version is called, no
    seed index goes up, `device_seed_s` stays 0 and `host_seeded` counts
    every record."""
    monkeypatch.setattr(pnp, "seed_and_find", lambda *a: pytest.fail("device seeding ran"))
    monkeypatch.setattr(pnp, "_resident_seed_index",
                        lambda *a: pytest.fail("the seed index was uploaded"))
    args = _pipeline_args(data)
    kw = HOST_SEEDING[mode]
    if workers == 1:
        pipe = pnp.NativePipeline(*args, **kw)
    else:
        pipe = pnp.ThreadedNativePipeline(*args, n_workers=workers, **kw)
    assert not pipe.device_seed
    out = []
    assert pipe.map_file(str(data / "se.fq"), "", False, 64, out.append) == 300
    assert pipe.timers()["device_seed_s"] == 0
    assert pipe.counters()["host_seeded"] == 300


def test_threaded_pipeline_uploads_the_seed_index_in_setup(data, monkeypatch):
    """The seed index goes up once, when the threaded pipeline is built
    (set-up), and the workers' pipelines find it there: mapping uploads
    nothing more."""
    monkeypatch.setattr(pnp, "_SEED_IX_CACHE", {})
    args = _pipeline_args(data)
    tp = pnp.ThreadedNativePipeline(*args, n_workers=2, device="cpu", device_seed=True)
    assert tp.device_seed
    (key, cached), = pnp._SEED_IX_CACHE.items()
    assert key == (id(args[0]), "cpu")
    monkeypatch.setattr(pnp, "_int64_bits", lambda a: pytest.fail("uploaded while mapping"))
    out = []
    assert tp.map_file(str(data / "se.fq"), "", False, 64, out.append) == 300
    assert pnp._SEED_IX_CACHE == {key: cached}
    assert tp.timers()["device_seed_s"] > 0
