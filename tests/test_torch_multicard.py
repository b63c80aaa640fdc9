"""The multi-device host of the port on the CPU, against rabbitsalign_tpu's
(which runs on the 8 virtual CPU devices of tests/conftest.py):

- the extend batches round-robin over a device list (`NativePipeline.
  _dispatch`, the JAX package's :459-469): batch i goes to entry i % n,
  with its q2 upload on that entry and its targets gathered from that
  entry's genome; SE and PE SAM equal `--no-tpu`, the one-entry port and
  the JAX package's 8-device `NativePipeline`;
- one genome upload per distinct entry across 3 workers and two
  `map_file` calls, held by the run (`DeviceRun`), each run its own;
- `ShardedIndex` over 2, 3 and 8 distinct entries: its three lookups
  equal the JAX `ShardedIndex(make_mesh(n))` and the port's one-device
  index (`find_runs_compact` through the host merge across devices);
  `build_sharded_index` gives one shard an entry; `--shard-index` through
  the CLI with several local devices equals the default run and the JAX
  run;
- `local_devices`, `check_devices` and `make_mesh`; no fallback: an
  absent card or a mixed list raises, and a worker's error on one entry
  fails the run.

The entries are `torch.device("cpu", i)`: their tensors live on the CPU,
where the wrappers take the kernels' plain versions (the extend through
`extend_batch_packed_resident_q2`), but the labels key the genome copies,
the shards and the round-robin as cards would. On a card each batch goes
through the native enqueue instead (`extend_q2_enqueue`); the card case
of the round-robin, each worker's batches and the genome each one used
through that entry, is tests/test_torch_cuda.py's
`test_two_entries_of_one_card_match_the_cpu`. Every output is integer, so
every comparison is exact.
"""

import threading

import numpy as np
import pytest
import torch

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu.native.engine import NativeEngine as JaxEngine
from rabbitsalign_tpu.parallel import sharding as jsh
from rabbitsalign_tpu.pipeline import native_pipeline as jnp_mod
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.native.engine import NativeEngine
from rabbitsalign_tpu_torch.parallel import sharding as psh
from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

from .test_sharded_index import _repetitive_world
from .test_torch_sharded_index import (_assert_compact_equal, _assert_lookup_equal, _jax_compaction,
                                       _jax_mesh, _keys, _port_index, _random_stub, _sentinel_stub)
from .test_torch_threaded import CHUNK, _inputs, world  # noqa: F401  (world: a fixture)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions at these sizes run as fast on one thread as on
    eight; torch's intra-op threads would only crowd the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENTRIES = [torch.device("cpu", i) for i in range(8)]


def _without_pg(path) -> bytes:
    return b"".join(line for line in open(path, "rb") if not line.startswith(b"@PG"))


@pytest.fixture(scope="module")
def repetitive_index():
    """Both packages' indexes of the repetitive world of
    tests/test_sharded_index.py (tandem repeats that make filtered runs)."""
    from rabbitsalign_tpu_torch.io.fasta import References

    genome, _, _, jax_index = _repetitive_world()
    refs = References()
    refs.add("chrR", genome.encode())
    return _port_index(refs, jax_index), jax_index


@pytest.fixture
def one_job_batches(monkeypatch):
    """Every job list dispatches, in batches of 64, as
    tests/test_engine.py:test_engine_device_parity runs the JAX package."""
    monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", 1)
    monkeypatch.setattr(JaxEngine, "MIN_DEVICE_JOBS", 1)


def _args(world):
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.map.common import MappingParameters

    _, _, _, refs, index = world
    mp = MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff)
    return index, index.parameters, refs, AlignmentParameters(), mp


def _port(world, pe=False, n_workers=None, chunk=CHUNK, **kw):
    """(bytes, pipeline) of the port's sequential (n_workers None) or
    threaded pipeline on the CPU, batches of 64, `chunk` reads a chunk."""
    if n_workers is None:
        pipe = pnp.NativePipeline(*_args(world), batch_size=64, device="cpu", **kw)
    else:
        pipe = pnp.ThreadedNativePipeline(*_args(world), batch_size=64, device="cpu",
                                          n_workers=n_workers, **kw)
    out = []
    pipe.map_file(*_inputs(world, pe), False, chunk, out.append)
    return b"".join(out), pipe


def _jax(world, pe=False, chunk=CHUNK):
    """(bytes, pipeline) of the JAX package's NativePipeline on its 8
    virtual CPU devices."""
    from rabbitsalign_tpu.align.aligner import AlignmentParameters
    from rabbitsalign_tpu.map.common import MappingParameters

    _, jax_refs, jax_index, _, _ = world
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = 2 * jax_index.filter_cutoff
    pipe = jnp_mod.NativePipeline(jax_index, jax_index.parameters, jax_refs,
                                  AlignmentParameters(), mp, use_device=True, batch_size=64)
    out = []
    pipe.map_file(*_inputs(world, pe), False, chunk, out.append)
    return b"".join(out), pipe


SMALL_CHUNK = 16  # reads a chunk: more batches than entries
_ONE_ENTRY = {}  # pe -> the one-entry port's (bytes, pipeline) at SMALL_CHUNK


def _one_entry(world, pe):
    if pe not in _ONE_ENTRY:
        _ONE_ENTRY[pe] = _port(world, pe, chunk=SMALL_CHUNK)
    return _ONE_ENTRY[pe]


@pytest.mark.parametrize("pe", [False, True], ids=["SE", "PE"])
def test_round_robin_over_eight_entries_matches_jax(world, one_job_batches, monkeypatch, pe):
    """Batch i of the pipeline is uploaded to entry i % 8 and extended
    against that entry's genome; the SAM equals --no-tpu, the one-entry
    port and the JAX package's 8-device pipeline."""
    import jax

    seen = []
    upload, extend = pnp.NativePipeline._upload, pnp.extend_batch_packed_resident_q2

    def extend_seen(buf, ref_codes, *args):
        seen[-1] = (seen[-1], ref_codes)
        return extend(buf, ref_codes, *args)

    def upload_seen(a, device):
        seen.append(device)
        return upload(a, device)

    monkeypatch.setattr(pnp.NativePipeline, "_upload", staticmethod(upload_seen))
    monkeypatch.setattr(pnp, "extend_batch_packed_resident_q2", extend_seen)
    got, pipe = _port(world, pe, chunk=SMALL_CHUNK, devices=ENTRIES)
    n = len(seen)
    assert pipe._next_dev == n > len(ENTRIES)  # every entry, and round again
    for i, (device, ref_codes) in enumerate(seen):
        assert device == ENTRIES[i % 8] and ref_codes is pipe._ref_codes[i % 8], i
    assert len({id(r) for r in pipe._ref_codes}) == 8  # one genome an entry
    assert pipe.dispatched == [len(range(k, n, 8)) for k in range(8)]
    assert pipe.dispatches() == pipe.dispatched

    monkeypatch.undo()
    monkeypatch.setattr(NativeEngine, "MIN_DEVICE_JOBS", 1)
    monkeypatch.setattr(JaxEngine, "MIN_DEVICE_JOBS", 1)
    one, one_pipe = _one_entry(world, pe)
    assert one_pipe.run.devices == [torch.device("cpu")] and one_pipe._next_dev == 0
    assert one_pipe.dispatched == [n]
    host, _ = _port(world, pe, chunk=SMALL_CHUNK, use_device=False)
    assert len(jax.local_devices()) == 8
    want, jax_pipe = _jax(world, pe, chunk=SMALL_CHUNK)
    assert jax_pipe._next_dev == n
    assert got == one == host == want
    assert len(got.splitlines()) >= (500 if pe else 400)


@pytest.mark.parametrize("entries", [[0, 1], [0, 1, 2, 3], [0, 0, 1]],
                         ids=["2", "4", "repeated"])
def test_genome_uploaded_once_per_distinct_entry(world, one_job_batches, monkeypatch, entries):
    """Three workers over 2 and 4 entries (and a list naming one entry
    twice): the genome is uploaded once a distinct entry, every worker
    splits its batches over the entries in turn, and the SE SAM equals
    the one-entry run's."""
    devices = [ENTRIES[i] for i in entries]
    uploads = []
    real = pnp.resident_ref_codes

    def counting(codes, device):
        uploads.append(device)
        return real(codes, device)

    monkeypatch.setattr(pnp, "resident_ref_codes", counting)
    got, pipe = _port(world, n_workers=3, chunk=SMALL_CHUNK, devices=devices)
    assert sorted(map(str, uploads)) == sorted({str(d) for d in devices})
    assert list(pipe.run._genomes) == list(dict.fromkeys(devices))  # every card's copy kept
    assert len(pipe.worker_dispatched) == 3
    for per_entry in pipe.worker_dispatched:
        n = sum(per_entry)
        assert per_entry == [len(range(k, n, len(devices))) for k in range(len(devices))]
    assert all(pipe.dispatches())  # every entry extended batches
    monkeypatch.undo()
    assert got == _one_entry(world, False)[0]


def test_genome_cache_keeps_each_cards_copy_and_drops_other_genomes(world, monkeypatch):
    """A run keeps one genome copy a distinct card (an entry named twice
    shares it): its first worker uploads it, and a second `map_file` on
    the same pipeline uploads nothing. Two runs on two genomes each hold
    their own copies: no process-wide cache keeps or drops either."""
    uploads = []
    real = pnp.resident_ref_codes
    monkeypatch.setattr(pnp, "resident_ref_codes",
                        lambda codes, device: uploads.append(device) or real(codes, device))
    pipe = pnp.ThreadedNativePipeline(*_args(world), batch_size=64, device="cpu", n_workers=2,
                                      devices=[*ENTRIES[:2], ENTRIES[0]])
    for _ in range(2):
        out = []
        pipe.map_file(*_inputs(world, False), False, SMALL_CHUNK, out.append)
        assert b"".join(out) == _one_entry(world, False)[0]
        assert uploads == ENTRIES[:2]

    class Engine:
        def __init__(self, codes):
            self.codes = codes

        def ref_codes(self):
            return self.codes

    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters

    runs = [pnp.DeviceRun(world[4], AlignmentParameters(), device="cpu", devices=ENTRIES[:2])
            for _ in range(2)]
    first = runs[0].genomes(Engine(np.zeros(4, np.uint8)))
    second = runs[1].genomes(Engine(np.ones(4, np.uint8)))
    assert uploads == ENTRIES[:2] * 3
    again = runs[0].genomes(Engine(np.full(4, 2, np.uint8)))  # cached: no upload
    assert uploads == ENTRIES[:2] * 3 and all(a is b for a, b in zip(again, first))
    assert all(int(g[:4].sum()) == 0 for g in first) and all(int(g[:4].sum()) == 4 for g in second)


@pytest.mark.parametrize("n_entries", [2, 3, 8])
def test_sharded_index_over_distinct_entries_matches_jax(repetitive_index, n_entries):
    """Shards on 2, 3 and 8 distinct entries, with the repetitive world
    (filtered runs) and stub indexes (random runs; the sentinel hash's
    long top run with empty trailing shards): find_runs and
    find_runs_routed equal the JAX mesh index's and the one-device
    index's, and find_runs_compact, merged on the host across the
    entries, the JAX package's host compaction and the one-device
    index's compaction, at the filter cutoff and at a small cap."""
    rng = np.random.RandomState(0xCA2D + n_entries)
    stubs = [_sentinel_stub(), *(_random_stub(rng) for _ in range(4))]
    for stub, jax_stub in [repetitive_index, *((stub, stub) for stub in stubs)]:
        across = psh.ShardedIndex(ENTRIES[:n_entries], stub)
        assert across.devices == ENTRIES[:n_entries] and len(across._tables) == n_entries
        one_device = psh.ShardedIndex(psh.make_mesh(n_entries, "cpu"), stub)
        single = psh.ShardedIndex(psh.make_mesh(1, "cpu"), stub)
        jax_si = jsh.ShardedIndex(_jax_mesh(n_entries), jax_stub)
        keys = _keys(stub, rng)
        for cap in (int(stub.filter_cutoff), int(rng.randint(1, 6))):
            for lookup in ("find_runs", "find_runs_routed"):
                got = getattr(across, lookup)(keys, cap)
                _assert_lookup_equal(got, getattr(jax_si, lookup)(keys, cap))
                _assert_lookup_equal(got, getattr(one_device, lookup)(keys, cap))
            got = across.find_runs_compact(keys, cap)
            _assert_compact_equal(got, one_device.find_runs_compact(keys, cap))
            _assert_compact_equal(got, single.find_runs_compact(keys, cap))
        _assert_compact_equal(across.find_runs_compact(keys), _jax_compaction(jax_si, keys))
        empty = across.find_runs_compact(np.zeros(0, np.uint64))
        _assert_compact_equal(empty, one_device.find_runs_compact(np.zeros(0, np.uint64)))


def test_build_sharded_index_gives_one_shard_an_entry(world):
    """`build_sharded_index` cuts one shard for each entry of the
    pipeline's device list, for one pipeline and for the workers' shared
    index; the default CPU list is one shard."""
    for entries in (ENTRIES[:3], ENTRIES):
        pipe = pnp.NativePipeline(*_args(world), device="cpu", shard_index=True,
                                  devices=entries)
        assert pipe.sharded_index.devices == entries and pipe.sharded_index.n_shards == len(entries)
        threaded = pnp.ThreadedNativePipeline(*_args(world), device="cpu", shard_index=True,
                                              devices=entries)
        assert threaded.sharded_index.devices == entries
    assert pnp.NativePipeline(*_args(world), device="cpu", shard_index=True).sharded_index.devices \
        == [torch.device("cpu")]
    assert pnp.build_sharded_index(world[4], torch.device("cpu")).n_shards == 1


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_shard_index_cli_on_several_local_devices(world, monkeypatch, capsys, mode):
    """The CLI on a host whose local devices are 4 entries (`local_devices`
    made to say so): `--shard-index` with 3 workers cuts 4 shards and
    spreads the extend batches over the 4 entries; its SAM equals the
    port's default run and the JAX package's `--shard-index` run."""
    real = psh.local_devices

    def four(device="cuda"):
        return ENTRIES[:4] if torch.device(device).type == "cpu" else real(device)

    monkeypatch.setattr(psh, "local_devices", four)
    monkeypatch.setattr(pnp, "local_devices", four)
    d = world[0]
    files = [d / "se.fq"] if mode == "se" else [d / "r1.fq", d / "r2.fq"]
    argv = [str(d / "ref.fa"), *map(str, files), "--chunk-size", "160",
            "--tpu-batch", "64", "-t", "3", "--deterministic", "-v"]
    out = {}
    for name, extra in (("port", ["--device", "cpu"]),
                        ("shard", ["--device", "cpu", "--shard-index"])):
        capsys.readouterr()
        assert port_main([*argv, *extra, "-o", str(d / f"multi.{name}.sam")]) == 0
        out[name] = _without_pg(d / f"multi.{name}.sam")
        err = capsys.readouterr().err
        assert "Extend dispatches an entry of the device list: [" in err
        if name == "shard":
            assert "4 shard(s) on cpu:0, cpu:1, cpu:2, cpu:3" in err and "feed misses 0" in err
    assert jax_main([*argv, "--shard-index", "-o", str(d / "multi.jax.sam")]) == 0
    assert out["port"] == out["shard"] == _without_pg(d / "multi.jax.sam")


def test_local_devices_and_make_mesh(monkeypatch):
    """`local_devices` lists every visible card for "cuda", the indexed
    card for "cuda:i", [cpu] for the CPU; `make_mesh(None, d)` is that
    list, `make_mesh(n, d)` n entries of one device."""
    cpu = torch.device("cpu")
    assert psh.local_devices("cpu") == [cpu] == psh.make_mesh(None, "cpu")
    assert psh.make_mesh(3, "cpu") == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert psh.local_devices("cuda") == cards == psh.make_mesh(None, "cuda")
    assert psh.local_devices("cuda:2") == [cards[2]]
    assert psh.make_mesh(2, "cuda") == [cards[0]] * 2
    assert psh.check_devices(["cuda", "cuda:1", "cuda:1"]) == [cards[0], cards[1], cards[1]]
    with pytest.raises(RuntimeError, match="no such CUDA device: cuda:3"):
        psh.check_devices(["cuda:0", "cuda:3"])
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        psh.local_devices("cuda:5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: psh.local_devices("cuda"), lambda: psh.make_mesh(None, "cuda"),
                 lambda: psh.check_devices(["cuda:0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_lists_that_cannot_run_are_refused(world):
    """No fallback: an absent card, an empty list, a list that mixes
    device types and a device that is neither cpu nor cuda all raise,
    in the pipeline, the sharded index and the prewarm."""
    absent = torch.device("cuda", torch.cuda.device_count() if torch.cuda.is_available() else 0)
    message = "no such CUDA device" if torch.cuda.is_available() else "no CUDA device"
    with pytest.raises(RuntimeError, match=message):
        pnp.NativePipeline(*_args(world), devices=[absent])
    with pytest.raises(RuntimeError, match=message):
        pnp.prewarm_device(absent).result()
    for bad in ([], [torch.device("cpu"), torch.device("meta")], [torch.device("meta")]):
        with pytest.raises(ValueError, match="on one device type"):
            pnp.NativePipeline(*_args(world), device="cpu", devices=bad)
        with pytest.raises(ValueError, match="every shard on one device type"):
            psh.ShardedIndex(bad, world[4])
    assert pnp._warm_device(ENTRIES[:2]) is None  # the CPU: nothing to build or probe


def test_worker_error_on_one_entry_fails_the_run(world, one_job_batches, monkeypatch):
    """An upload that fails on entry 1 raises in its worker and fails the
    run, in bounded time; no batch goes to another entry or to the host
    instead."""
    upload = pnp.NativePipeline._upload
    after_failure = []

    def failing(a, device):
        if device == ENTRIES[1]:
            raise RuntimeError("upload to cpu:1 failed (test)")
        if after_failure:
            after_failure.append(device)
        return upload(a, device)

    monkeypatch.setattr(pnp.NativePipeline, "_upload", staticmethod(failing))
    result = {}

    def run():
        try:
            _port(world, n_workers=3, devices=ENTRIES[:2])
        except RuntimeError as e:
            result["error"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "map_file hung after a worker failed"
    assert result.get("error") == "upload to cpu:1 failed (test)"
    with pytest.raises(RuntimeError, match="upload to cpu:1 failed"):
        _port(world, devices=ENTRIES[:2])


def test_stream_context_on_the_cpu_makes_no_stream(world):
    pipe = pnp.NativePipeline(*_args(world), device="cpu", devices=ENTRIES[:2])
    with pipe.stream_context():
        assert pipe.streams == {}
