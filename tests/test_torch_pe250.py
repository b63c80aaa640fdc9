"""2x250 paired-end reads under the r = 250 index profile (k 20, s 16,
w_min 8, w_max 17, max_dist 180), the profile the CLI estimates for
them, on the CPU: the 3-worker main path with the seeding and extend
kernels' plain versions against the host path, byte for byte; the
device seeding's arrays against the reference randstrobes; every extend
job of 250-base reads in the profile's tight (256, 360) bucket, and the
pipeline's counters of it; and the mate rescue against the JAX
package's on the same input."""

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
from rabbitsalign_tpu_torch.native.engine import ENGINE_BUCKETS, engine_buckets
from rabbitsalign_tpu_torch.ops import seed_device as psd
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp
from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_reference

from .torch_extend_cases import revcomp, write_pe250
from .torch_seed_cases import code_batch


@pytest.fixture(scope="module")
def pe250(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pe250")
    random_mate = write_pe250(d, seed=250)
    return d, random_mate


def _without_pg(path) -> bytes:
    return b"".join(line for line in open(path, "rb") if not line.startswith(b"@PG"))


def _pipeline(d, r: int, cls=pnp.ThreadedNativePipeline, **kwargs):
    refs = References.from_fasta(str(d / "ref.fa"))
    index = StrobemerIndex(refs, IndexParameters.from_read_length(r))
    index.populate(0.0002)
    mp = MappingParameters(r=r, rescue_cutoff=min(2 * index.filter_cutoff, 1000))
    return cls(index, index.parameters, refs, AlignmentParameters(), mp, **kwargs)


def test_the_profile_of_250_base_reads():
    p = IndexParameters.from_read_length(250)
    assert (p.syncmer.k, p.syncmer.s) == (20, 16)
    assert (p.randstrobe.w_min, p.randstrobe.w_max, p.randstrobe.max_dist) == (8, 17, 180)
    assert engine_buckets(250)[0][:3] == (256, 360, 512)
    assert engine_buckets(250)[1:] == ENGINE_BUCKETS


def test_main_path_with_plain_kernels_matches_host_path(pe250, capsys):
    """The CLI's default 3 workers (`ThreadedNativePipeline`) with the
    seeding and extend kernels' plain versions (`--device cpu
    --device-seed`) write the SAM of the host path (`--no-tpu`); both
    estimate r = 250 from the reads, and the extend batches reach the
    (plain) device."""
    d, _ = pe250
    argv = [str(d / "ref.fa"), str(d / "r1.fq"), str(d / "r2.fq"), "--chunk-size", "150",
            "--tpu-batch", "64"]
    assert port_main(argv + ["--device", "cpu", "--device-seed", "-v",
                             "-o", str(d / "plain.sam")]) == 0
    log = capsys.readouterr().err
    assert "Estimated read length: 250 bp" in log
    extend = re.search(r"Device extend: (\d+) jobs, \d+ DP cells in (\d+) batches.*; (\d+) "
                       r"planned, (\d+) in the tight bucket", log)
    assert extend, log[-3000:]
    jobs, batches, planned, tight = map(int, extend.groups())
    assert jobs > 0 and batches > 0 and tight == planned >= jobs
    assert port_main(argv + ["--no-tpu", "-o", str(d / "host.sam")]) == 0
    assert "Estimated read length: 250 bp" in capsys.readouterr().err
    plain = _without_pg(d / "plain.sam")
    assert plain == _without_pg(d / "host.sam")
    assert len(plain.splitlines()) >= 600


def test_seed_and_find_matches_the_reference_randstrobes(pe250):
    """`seed_and_find` on the CPU at the 250 profile: each read's forward
    strobes are `randstrobes_reference` of the read, its reverse ones
    those of its reverse complement, and each strobe's position is the
    index's `find`; no random read is a tie row."""
    d, _ = pe250
    refs = References.from_fasta(str(d / "ref.fa"))
    p = IndexParameters.from_read_length(250)
    index = StrobemerIndex(refs, p)
    index.populate(0.0002)
    reads = [line.strip() for i, line in enumerate(open(d / "r1.fq", "rb")) if i % 4 == 1]
    reads = reads[:120] + [line.strip() for i, line in enumerate(open(d / "r2.fq", "rb"))
                           if i % 4 == 1][:40]
    codes, lens = code_batch(reads)
    sp, rp = p.syncmer, p.randstrobe
    # hashes, buckets
    ix = pnp.DeviceRun(index, AlignmentParameters(), device="cpu", device_seed=True).seed_index[:2]
    buf, total = psd.seed_and_find(torch.from_numpy(codes), torch.from_numpy(lens), *ix, sp.k,
                                   sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist,
                                   pnp.NativePipeline.SEED_L, index.bits)
    counts, offsets, hashes, starts, ends, is_rev, positions = (
        x.numpy() for x in psd.strobe_views(buf, len(reads), total))
    assert (counts >= 0).all() and total == counts.sum() > 60 * len(reads)
    hashes = hashes.view(np.uint64)
    for i, read in enumerate(reads):
        rows = slice(offsets[i], offsets[i] + counts[i])
        for strand, seq in ((0, read), (1, revcomp(read))):
            h, s1, s2 = randstrobes_reference(seq, p)
            mine = rows.start + np.flatnonzero(is_rev[rows] == strand)
            assert np.array_equal(hashes[mine], h)
            assert np.array_equal(starts[mine], s1) and np.array_equal(ends[mine], s2 + sp.k)
    assert np.array_equal(positions, index.find(hashes))
    assert (positions >= 0).mean() > 0.3  # the read's own strand hits, less its edits


@pytest.mark.parametrize("r", [250, 150], ids=["r250", "r150"])
def test_extend_jobs_of_250_base_reads_plan_into_the_tight_bucket(pe250, r):
    """Under the 250 profile every extend job of the 2x250 input plans
    into (256, 360) and the counters say so, summed over the workers and
    equal to the engines' `job_shapes()`; under the 150 profile none fits
    (152, 256) and they go to the legacy (256, 512)."""
    d, _ = pe250
    pipe = _pipeline(d, r, use_device=True, n_workers=2, device="cpu", batch_size=64)
    shapes = []
    real = pnp.NativePipeline.counters

    def counted(self):
        shapes.append(self.engine.job_shapes())
        return real(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pnp.NativePipeline, "counters", counted)
        assert pipe.map_file(str(d / "r1.fq"), str(d / "r2.fq"), False, 150, lambda b: None) == 600
    c = pipe.counters()
    assert len(shapes) == 2
    planned = sum(sum(n for _, _, n in s["buckets"]) + s["unbucketed"] for s in shapes)
    assert c["planned_jobs"] == planned > 100
    by_shape = {}
    for s in shapes:
        for q, t, n in s["buckets"]:
            by_shape[(q, t)] = by_shape.get((q, t), 0) + n
    if r == 250:
        assert c["tight_jobs"] == by_shape[(256, 360)] == planned
    else:
        assert c["tight_jobs"] == by_shape[(152, 256)] == 0 and by_shape[(256, 512)] == planned


def test_tight_jobs_is_zero_without_a_tight_bucket(pe250):
    """An engine laid out with the legacy buckets alone counts every job
    as planned and none as tight."""
    d, _ = pe250
    pipe = _pipeline(d, 250, pnp.NativePipeline, use_device=True, device="cpu", batch_size=64)
    pipe.engine.buckets = ENGINE_BUCKETS
    pipe.engine._shape_bucket = np.zeros(len(ENGINE_BUCKETS) + 1, np.int64)
    assert pipe.map_file(str(d / "r1.fq"), str(d / "r2.fq"), False, 150, lambda b: None) == 600
    c = pipe.counters()
    assert c["tight_jobs"] == 0 and c["planned_jobs"] > 100


def _rescued(log: str) -> int:
    return int(re.search(r"Mates rescued by alignment: (\d+)", log).group(1))


@pytest.mark.parametrize("read_len", [250, 150])
def test_mate_rescue_matches_jax(tmp_path, read_len, capsys):
    """The port's mate rescue on the same pairs as the JAX package's:
    the same count of rescued mates and the same SAM. At 250 bases every
    mate of the input finds its own NAMs and no random mate shares a
    13-mer with its window (the reference's `has_shared_substring`), so
    none is rescued; in the 150-base control, cut from the same pairs,
    some real mates find no NAM of their own and are rescued, and the
    random mates are not."""
    random_mate = write_pe250(tmp_path, seed=2502, n_pairs=400, deletion_every=12,
                              random_every=10)
    if read_len == 150:  # the same pairs, each mate cut to its first 150 bases
        for name in ("r1.fq", "r2.fq"):
            lines = open(tmp_path / name, "rb").read().split(b"\n")
            lines[1::4] = [x[:150] for x in lines[1::4]]
            lines[3::4] = [x[:150] for x in lines[3::4]]
            (tmp_path / name).write_bytes(b"\n".join(lines))
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
            "--no-tpu", "-t", "1", "-v"]
    assert port_main(argv + ["-o", str(tmp_path / "port.sam")]) == 0
    port = _rescued(capsys.readouterr().err)
    assert jax_main(argv + ["-o", str(tmp_path / "jax.sam")]) == 0
    assert _rescued(capsys.readouterr().err) == port
    assert _without_pg(tmp_path / "port.sam") == _without_pg(tmp_path / "jax.sam")
    unmapped = set()
    for line in open(tmp_path / "port.sam", "rb"):
        f = line.split(b"\t")
        if not line.startswith(b"@") and int(f[1]) & 0x80 and int(f[1]) & 0x4:
            unmapped.add(int(f[0][1:]))
    assert unmapped == {i for i, r in enumerate(random_mate) if r}
    # 250 bases: every mate of a real pair has its own NAM; 150: some have none
    assert (port == 0) if read_len == 250 else (port > 0)
