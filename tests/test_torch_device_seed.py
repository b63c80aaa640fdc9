"""`--device-seed` on the CPU (`--device cpu`: the seeding, lookup and run
walk kernels' plain PyTorch versions): the port's SAM equals its own
default run (host seeding) and rabbitsalign_tpu's CLI with
`--device-seed`, SE and PE, one mapping thread and two workers, apart
from the @PG line; and SE through `ThreadedNativePipeline` with 2 workers
equals host seeding. The reads include tandem repeats (min-queue ties)
and reads longer than the device's 256 bases, which the engine seeds on
the host. The run walk on the device (`walk_hits_compact`) gives the
engine the hits its host walk would: the same SAM as the host walk on
the device's strobes and as `--no-tpu`, for 2x150, 2x250 and SE indel
reads and on a genome of planted repeats, and the same hits read by
read as the Python host path's walk."""

import re

import numpy as np
import pytest
import torch

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.index.params import IndexParameters
from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.map.common import MappingParameters
from rabbitsalign_tpu_torch.ops import seed_device
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from .torch_extend_cases import READ_LEN, revcomp, sim_read, write_fastq, write_pe250


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions at these sizes run as fast on one thread as on
    eight; torch's intra-op threads would only crowd the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert port_main([str(data / "ref.fa"), str(data / "se.fq"), "-t", "1", "--device-seed",
                      "-o", str(data / "nogpu.sam")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("device,kw,extends,seeds", [
    pytest.param("cuda", {}, True, True, id="cuda-False-True"),
    pytest.param("cuda:0", {}, True, True, id="cuda:0-False-True"),
    pytest.param("cuda", {"device_seed": True}, True, True, id="cuda-True-True"),
    pytest.param("cpu", {}, True, False, id="cpu-False-False"),
    pytest.param("cpu", {"device_seed": True}, True, True, id="cpu-True-True"),
    pytest.param("cuda", {"gap_extend": 12}, False, False, id="gap-rule"),
    pytest.param("cpu", {"gap_extend": 12, "device_seed": True}, False, False,
                 id="gap-rule-cpu"),
    pytest.param("cuda", {"use_device": False, "device_seed": True}, False, False,
                 id="no-tpu"),
    pytest.param("cuda", {"shard_index": True}, True, False, id="shard-index"),
    pytest.param("cpu", {"shard_index": True, "device_seed": True}, True, False,
                 id="shard-index-cpu"),
])
def test_seeds_on_device_where_the_extend_runs_on_a_card(device, kw, extends, seeds,
                                                         monkeypatch):
    """The run's one decision (`DeviceRun`): phase A seeds on the first
    device of the extend's list where it is a CUDA card, with or without
    --device-seed, and on the CPU only where the flag asks for the plain
    versions; the gap rule (gap_extend = gap_open: no device extend) and
    --no-tpu leave the extend and the seeding on the host, and
    --shard-index takes precedence over seeding on the device. The seed
    index goes up exactly where phase A seeds on the device. The CUDA
    cases run here with the card's list and uploads stubbed."""
    kw = dict(kw)
    aln = AlignmentParameters(gap_open=12, gap_extend=kw.pop("gap_extend", 1))
    uploads = []
    monkeypatch.setattr(pnp, "local_devices", lambda d="cuda": [torch.device(d)])
    monkeypatch.setattr(pnp, "_seed_index_on", lambda index, d: uploads.append(d) or "ix")
    monkeypatch.setattr(pnp, "build_sharded_index", lambda index, d, devices: "shards")
    run = pnp.DeviceRun(None, aln, device=device, **kw)
    assert run.use_device is extends and run.device_seed is seeds
    assert run.device == torch.device(device)
    assert uploads == ([run.device] if seeds else [])
    assert run.seed_index == ("ix" if seeds else None)
    assert run.sharded_index == ("shards" if kw.get("shard_index") else None)
    extends_or_shards = extends or kw.get("shard_index", False)
    assert run.cards == ([run.device] if extends_or_shards and device != "cpu" else [])
    assert pnp.extends_on_device(kw.get("use_device", True), aln) is extends


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
    seed index goes up, `device_seed_s` stays 0 and `host_seeded` and
    `host_walked` count every record."""
    monkeypatch.setattr(pnp, "seed_and_find", lambda *a: pytest.fail("device seeding ran"))
    monkeypatch.setattr(pnp, "_seed_index_on",
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
    assert pipe.counters()["host_seeded"] == pipe.counters()["host_walked"] == 300


def test_threaded_pipeline_uploads_the_seed_index_in_setup(data, monkeypatch):
    """The seed index goes up once, when the threaded pipeline is built
    (set-up), and the workers' pipelines find it there: mapping, twice,
    uploads nothing more."""
    uploads = []
    real = pnp._seed_index_on
    monkeypatch.setattr(pnp, "_seed_index_on",
                        lambda index, d: uploads.append((index, d)) or real(index, d))
    args = _pipeline_args(data)
    tp = pnp.ThreadedNativePipeline(*args, n_workers=2, device="cpu", device_seed=True)
    assert tp.device_seed and uploads == [(args[0], torch.device("cpu"))]
    cached = tp.run.seed_index
    assert len(cached) == 4
    monkeypatch.setattr(pnp, "_signed_bits", lambda a: pytest.fail("uploaded while mapping"))
    for _ in range(2):
        out = []
        assert tp.map_file(str(data / "se.fq"), "", False, 64, out.append) == 300
        assert tp.timers()["device_seed_s"] > 0
    assert len(uploads) == 1 and tp.run.seed_index is cached


# --- the run walk on the device ------------------------------------------

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _dna(rng, n: int) -> bytes:
    return rng.choice(ACGT, n).tobytes()


def _deleted(genome: bytes, rng, n: int, length: int = READ_LEN):
    """`n` reads of `length` bases with a 1-5 bp deletion at 40-100 and
    up to 3 substitutions, one in four reverse-complemented."""
    reads = []
    for i in range(n):
        st, cut, g = rng.randint(len(genome) - 2 * length), rng.randint(40, 100), rng.randint(1, 6)
        rd = bytearray(genome[st:st + cut] + genome[st + cut + g:st + length + g])
        for _ in range(rng.randint(4)):
            rd[rng.randint(length)] = b"ACGT"[rng.randint(4)]
        reads.append(revcomp(bytes(rd)) if i % 4 == 1 else bytes(rd))
    return reads


def _repeat_genome(rng):
    """Four contigs of random bases with planted repeats: a 400-base unit
    twice and another three times across the contigs (runs of 2 and 3
    rows that the device walks), a 300-base unit six times (reads inside
    it keep more hits than they have strobes: their hits overflow) and a
    100-base unit 130 times in tandem (runs past the filter's cutoff).
    Returns (contigs, units)."""
    u2, u3, u6, u130 = _dna(rng, 400), _dna(rng, 400), _dna(rng, 300), _dna(rng, 100)
    plant = [[u2, u3, u6, u6], [u3, u6, u130 * 130], [u2, u3, u6], [u6, u6]]
    contigs = []
    for units in plant:
        parts = [_dna(rng, 6000)]
        for u in units:
            parts += [u, _dna(rng, 6000)]
        contigs.append(b"".join(parts))
    return contigs, (u2, u3, u6, u130 * 3)


@pytest.fixture(scope="module")
def walk_worlds(tmp_path_factory):
    """Small inputs of each kind the main path maps, each a directory with
    ref.fa and its reads: 2x150 pairs, 2x250 pairs (mapped under the 250
    profile), SE reads with a deletion each, and SE reads on the planted
    repeats of `_repeat_genome`, with random reads (no NAM: the rescue
    fires), tie rows and reads longer than 256 bases among them."""
    root = tmp_path_factory.mktemp("walk_worlds")
    rng = np.random.RandomState(2207)
    worlds = {}
    d = worlds["pe150"] = root / "pe150"
    d.mkdir()
    genome = _dna(rng, 100_000)
    (d / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    r1, r2 = [], []
    for i in range(90):
        st, insert = rng.randint(len(genome) - 1000), int(np.clip(rng.normal(300, 30), 200, 500))
        r1.append(sim_read(genome, st, rng))
        r2.append(_dna(rng, READ_LEN) if i % 30 == 7 else
                  revcomp(sim_read(genome, st + insert - READ_LEN, rng)))
    write_fastq(d / "r1.fq", r1, b"p")
    write_fastq(d / "r2.fq", r2, b"p")
    d = worlds["pe250"] = root / "pe250"
    d.mkdir()
    write_pe250(d, seed=2208, n_pairs=60, genome_bp=100_000, deletion_every=3)
    d = worlds["se-indel"] = root / "se-indel"
    d.mkdir()
    (d / "ref.fa").write_bytes(b">chr1\n" + genome + b"\n")
    write_fastq(d / "r1.fq", _deleted(genome, rng, 90), b"s")
    d = worlds["repeats"] = root / "repeats"
    d.mkdir()
    contigs, units = _repeat_genome(rng)
    (d / "ref.fa").write_bytes(b"".join(b">c%d\n%s\n" % (i, c) for i, c in enumerate(contigs)))
    reads = []
    for c in contigs:  # across each contig and its repeats
        for st in rng.randint(0, len(c) - READ_LEN, 30):
            reads.append(bytes(c[st:st + READ_LEN]))
    for u in units:  # inside each unit, and across its ends
        for j in range(6):
            st = rng.randint(0, len(u) - 60)
            reads.append((u + _dna(rng, READ_LEN))[st:st + READ_LEN])
    reads += [_dna(rng, READ_LEN) for _ in range(5)]
    reads += [(bytes(_dna(rng, 3)) * 60)[:READ_LEN] for _ in range(3)]  # tie rows
    reads += [contigs[0][100:400], contigs[2][5000:5300]]  # longer than SEED_L
    write_fastq(d / "r1.fq", [revcomp(r) if i % 3 == 1 else r for i, r in enumerate(reads)],
                b"s")
    return worlds


WALK_WORLDS = {"pe150": (150, True), "pe250": (250, True), "se-indel": (150, False),
               "repeats": (150, False)}


def _world_args(d, r: int):
    refs = References.from_fasta(str(d / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(r))
    index.populate(0.0002)
    mp = MappingParameters(r=r, rescue_cutoff=min(2 * index.filter_cutoff, 1000))
    return index, index.parameters, refs, AlignmentParameters(), mp


# the runs compared: the device's walk (the main path), the host's walk of
# the device's strobes (every record's walk flagged as overflowed, so that
# the engine walks it on the host index), and --no-tpu
ROUTES = ("device-walk", "host-walk", "no-tpu")


def _all_overflowed(real):
    """`NativeEngine.chunk_a_fx_pre` with every record's overflow flag set."""
    def call(self, *arrays, walk):
        return real(self, *arrays, walk=[*walk[:4], np.ones_like(walk[4])])
    return call


def _map_routes(d, paired: bool, args, workers: int, monkeypatch) -> dict:
    """Each route's SAM bytes and counters through `ThreadedNativePipeline`
    (deterministic, so that PE bytes depend on the worker count only)."""
    from rabbitsalign_tpu_torch.native.engine import NativeEngine

    out = {}
    for route in ROUTES:
        kw = ({"use_device": False} if route == "no-tpu" else
              {"use_device": True, "device": "cpu", "device_seed": True})
        with monkeypatch.context() as m:
            if route == "host-walk":
                m.setattr(NativeEngine, "chunk_a_fx_pre",
                          _all_overflowed(NativeEngine.chunk_a_fx_pre))
            tp = pnp.ThreadedNativePipeline(*args, n_workers=workers, batch_size=64,
                                            deterministic=True, **kw)
            text = []
            tp.map_file(str(d / "r1.fq"), str(d / "r2.fq") if paired else "", False, 40,
                        text.append)
        out[route] = (b"".join(text), tp.counters())
    return out


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("world", list(WALK_WORLDS))
def test_device_walk_matches_the_host_walk(walk_worlds, world, workers, monkeypatch):
    """The SAM of the device's run walk (the plain version of
    csrc/walk_hits.cu) equals the host walk's on the same device strobes
    (the route before the walk moved to the device) and `--no-tpu`'s, at
    one and three workers: 2x150 pairs with random mates, 2x250 pairs
    under the 250 profile, SE reads with a deletion each, and SE reads on
    planted repeats, where runs of several rows are walked, strobes are
    filtered, hits fall on several contigs, the rescue fires, and reads
    whose hits overflow their room go to the engine. `host_walked` counts
    the tie rows, long reads and overflows where the device walks, every
    record under --no-tpu."""
    r, paired = WALK_WORLDS[world]
    d = walk_worlds[world]
    args = _world_args(d, r)
    out = _map_routes(d, paired, args, workers, monkeypatch)
    sam = out["device-walk"][0]
    assert sam == out["host-walk"][0]
    assert sam == out["no-tpu"][0]
    n_records = sum(1 for ln in sam.splitlines() if not ln.startswith(b"@")
                    and not int(ln.split(b"\t")[1]) & 0x900)
    walked, host = out["device-walk"][1], out["no-tpu"][1]
    assert host["host_walked"] == host["host_seeded"] == n_records
    assert out["host-walk"][1]["host_walked"] == walked["host_walked"]
    if world != "repeats":
        assert walked["host_walked"] == walked["host_seeded"] == 0
        return
    index = args[0]
    assert walked["host_seeded"] == 5  # three tie rows, two long reads
    assert walked["host_walked"] > walked["host_seeded"]  # the six-copy unit's reads
    assert walked["nam_rescue"] > 5
    assert index.filter_cutoff < 130 and 6 < index.filter_cutoff
    assert len({ln.split(b"\t")[2] for ln in sam.splitlines()
                if not ln.startswith(b"@")} - {b"*"}) == 4


@pytest.mark.parametrize("world", list(WALK_WORLDS))
def test_device_walk_matches_jax(walk_worlds, world, monkeypatch, capsys):
    """The port's CLI with the run walk on the (CPU) device writes the SAM
    of rabbitsalign_tpu's CLI with `--device-seed` on each input the walk
    tests map, apart from the @PG line: the walk ran once a chunk, and on
    the planted repeats records whose hits overflowed their room were
    walked on the host beside the tie and long reads."""
    calls = []
    real = pnp.walk_hits_compact
    monkeypatch.setattr(pnp, "walk_hits_compact", lambda *a: calls.append(1) or real(*a))
    _, paired = WALK_WORLDS[world]
    d = walk_worlds[world]
    reads = [d / "r1.fq", *([d / "r2.fq"] if paired else [])]
    argv = [str(d / "ref.fa"), *map(str, reads), "--tpu-batch", "64", "--chunk-size", "40",
            "-t", "1"]
    port_sam, jax_sam = d / "port-walk.sam", d / "jax-walk.sam"
    assert port_main(argv + ["--device", "cpu", "--device-seed", "-o", str(port_sam)]) == 0
    log = capsys.readouterr().err
    assert len(calls) >= 2  # every chunk of 40 reads or pairs
    assert jax_main(argv + ["--device-seed", "-o", str(jax_sam)]) == 0
    assert _without_pg(port_sam) == _without_pg(jax_sam)
    seeded, walked = (int(x) for x in re.search(
        r"(\d+) tie or long reads seeded on the host, (\d+) reads' runs walked", log).groups())
    assert walked > seeded == 5 if world == "repeats" else walked == seeded == 0


def _host_hits(index, hashes, starts, ends, is_rev):
    """The Python host path's hit collection of one read's strobes
    (chain/nams.py: find_nams' filter and `_add_to_hits_per_ref`): the
    groups of each orientation in first-touch order, and the found and
    unfiltered counts."""
    from rabbitsalign_tpu_torch.chain.nams import _add_to_hits_per_ref

    groups = [{}, {}]
    pos = index.find(hashes)
    total = int((pos >= 0).sum())
    good = 0
    for i in np.flatnonzero(pos >= 0):
        if index.is_filtered(int(pos[i])):
            continue
        good += 1
        _add_to_hits_per_ref(groups[int(is_rev[i])], int(starts[i]), int(ends[i]), index,
                             int(pos[i]))
    return groups, total, good


def test_walk_plain_at_the_cutoff_equals_the_host_walk(walk_worlds):
    """`walk_hits_plain` in the compact layout at cap = the filter cutoff,
    read by read on the planted repeats: the groups rebuilt from its hits
    in order equal the host path's groups, key order and hit order
    included, with the same found and unfiltered counts; a read
    overflows exactly where the host keeps more hits than it has
    strobes."""
    from rabbitsalign_tpu_torch.ops import front_device, seed_device

    from .torch_seed_cases import code_batch

    d = walk_worlds["repeats"]
    index = _world_args(d, 150)[0]
    reads = [ln.strip() for i, ln in enumerate(open(d / "r1.fq", "rb")) if i % 4 == 1]
    codes, lens = code_batch(reads)
    ix = pnp.DeviceRun(index, AlignmentParameters(), device="cpu", device_seed=True).seed_index
    p = index.parameters
    buf, total = seed_device.seed_and_find(
        torch.from_numpy(codes), torch.from_numpy(lens), *ix[:2], p.syncmer.k, p.syncmer.s,
        p.syncmer.t_syncmer, p.randstrobe.w_min, p.randstrobe.w_max, p.randstrobe.q,
        p.randstrobe.max_dist, pnp.NativePipeline.SEED_L, index.bits)
    views = seed_device.strobe_views(buf, len(reads), total)
    cutoff = index.filter_cutoff
    hits, n_hits, n_total, good, overflow = (x.numpy() for x in front_device.walk_hits_plain(
        *views, ix[0], ix[2], ix[3], p.syncmer.k, cutoff, 0, cutoff))
    counts, offsets, hashes, starts, ends, is_rev, _ = (x.numpy() for x in views)
    seen = {"multi_row": False, "filtered": False, "overflow": False, "contigs": set()}
    for b in np.flatnonzero(counts >= 0):
        rows = slice(offsets[b], offsets[b] + counts[b])
        want, w_total, w_good = _host_hits(index, hashes[rows].view(np.uint64), starts[rows],
                                           ends[rows], is_rev[rows])
        assert (n_total[b], good[b]) == (w_total, w_good)
        kept = sum(len(h) for g in want for h in g.values())
        assert overflow[b] == (kept > counts[b])
        seen["filtered"] |= w_good < w_total
        if overflow[b]:
            seen["overflow"] = True
            assert n_hits[b] == counts[b]
            continue
        got = [{}, {}]
        for rc, ref_id, qs, qe, rs, re in hits[offsets[b]:offsets[b] + n_hits[b]]:
            got[rc].setdefault(int(ref_id), []).append((int(qs), int(qe), int(rs), int(re)))
        assert [list(g.items()) for g in got] == [list(g.items()) for g in want]
        assert n_hits[b] == kept
        strobes = [(rc, h[:2]) for rc in (0, 1) for v in got[rc].values() for h in v]
        seen["multi_row"] |= len(set(strobes)) < len(strobes)
        seen["contigs"] |= {ref_id for g in got for ref_id in g}
    assert (seen["multi_row"], seen["filtered"], seen["overflow"]) == (True, True, True)
    assert seen["contigs"] == {0, 1, 2, 3}
