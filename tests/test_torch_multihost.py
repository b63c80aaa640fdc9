"""The multi-host pod run of the port (rabbitsalign_tpu_torch/parallel/
multihost.py, `NativePipeline.map_file_sharded`, the runner's `_map_pod`)
on the CPU, against rabbitsalign_tpu's:

- `shard_chunks`, `ShardWriter` and `merge_output` write the same bytes
  and manifests as the JAX package's;
- `init_distributed`, `psum_statistics` and `barrier` in two gloo
  processes (tcp:// and env:// rendezvous), and as no-ops in one;
- `PodShardedIndex`, every host of a pod built in this process on its own
  port: `find_runs_compact` equals the compaction of the JAX package's
  `PodShardedIndex.find_runs_routed` and the port's one-shard
  `ShardedIndex.find_runs_compact`, and `find_runs_routed` the JAX one,
  at caps 1, the filter cutoff and 1000, on the repetitive world and on
  stubs with the sentinel run and empty slices;
- two `--device cpu --num-nodes 2` CLI processes: the merged SE SAM and
  PAF, with and without `--pod-index-peers` and `--no-tpu`, equal the
  port's single-process run and the JAX package's CLI apart from @PG; the
  PE pod run equals the JAX package's PE pod run.

Every child process runs ``python -m`` with the repository root on
PYTHONPATH (the packages need not be installed) and one intra-op thread
(two processes of plain PyTorch extends would otherwise oversubscribe the
cores).
"""

import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu.parallel import multihost as jmh
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.io.fasta import References
from rabbitsalign_tpu_torch.parallel import multihost as pmh
from rabbitsalign_tpu_torch.parallel import sharding as psh

from .test_sharded_index import _repetitive_world
from .test_torch_sharded_index import (_Stub, _assert_compact_equal, _keys, _port_index,
                                       _sentinel_stub)
from .util import random_dna

ROOT = Path(__file__).resolve().parents[1]
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
TOP = np.uint64(0xFFFFFFFFFFFFFFFF)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one CPU device a JAX process
    env["OMP_NUM_THREADS"] = "1"
    env["RSB_POD_TIMEOUT"] = "120"
    env["RSB_POD_CONNECT_TIMEOUT"] = "120"
    env.update(extra)
    return env


def _run_all(cmds, cwd, env=None, timeout=240):
    """Start every command at once; wait for all; (stdout, stderr) each.
    A child that exits non-zero fails the test at once with its stderr,
    and the others are killed: a pod host whose peer died would wait for
    it until its own timeout."""
    logs = [(tempfile.TemporaryFile(), tempfile.TemporaryFile()) for _ in cmds]
    procs = [subprocess.Popen(c, stdout=out, stderr=err, cwd=cwd,
                              env=env if env is not None else _child_env())
             for c, (out, err) in zip(cmds, logs)]

    def read(f) -> str:
        f.seek(0)
        return f.read().decode()

    def failed(i) -> str:
        return f"child {i} exited {procs[i].returncode}:\n{read(logs[i][1])[-3000:]}"

    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                assert p.returncode in (None, 0), failed(i)
            assert time.monotonic() < deadline, f"children still running after {timeout} s"
            time.sleep(0.1)
        for i, p in enumerate(procs):
            assert p.returncode == 0, failed(i)
        return [(read(out), read(err)) for out, err in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


# The JAX package's runner starts its prewarm thread (prewarm_extend_programs,
# whose JAX calls bring the XLA backend up) before it calls
# jax.distributed.initialize, which refuses to run once the backend is up.
# Where the thread wins, that host exits at once and its peer waits in
# initialize for its initialization timeout (300 s). The JAX pod children
# run the JAX CLI with its prewarm started once the host has joined the
# pod; the prewarm only compiles, so the output is the same.
JAX_POD_CHILD = """
import sys, threading
from rabbitsalign_tpu.cli import main
from rabbitsalign_tpu.parallel import multihost
from rabbitsalign_tpu.pipeline import native_pipeline

joined = threading.Event()
init, prewarm = multihost.init_distributed, native_pipeline.prewarm_extend_programs

def init_then_release(*args, **kw):
    try:
        return init(*args, **kw)
    finally:
        joined.set()

def prewarm_once_joined(*args, **kw):
    t = threading.Thread(target=lambda: joined.wait() and prewarm(*args, **kw), daemon=True)
    t.start()
    return t

multihost.init_distributed = init_then_release
native_pipeline.prewarm_extend_programs = prewarm_once_joined
sys.exit(main(sys.argv[1:]))
"""


# --- shards, manifests, merge ----------------------------------------------

@pytest.mark.parametrize("header", ["", "@HD\tVN:1.6\tSO:unsorted\n"], ids=["no-header", "header"])
@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_shard_writer_and_merge_match_jax(tmp_path, hosts, header):
    """Each host's shard and manifest, and node 0's merge, are the JAX
    package's bytes; the merge is the header and the chunks in order."""
    rng = random.Random(hosts)
    chunks = [(ci, "".join(f"r{ci}.{i}\t{rng.randrange(10**6)}\n" for i in range(rng.randrange(4))))
              for ci in range(11)]
    chunks[3] = (3, chunks[3][1].encode())  # write_chunk takes bytes too
    for pkg in (jmh, pmh):
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        for p in range(hosts):
            w = pkg.ShardWriter(str(d / "out.sam"), p, hosts)
            for ci, text in pkg.shard_chunks(iter(chunks), p, hosts):
                w.write_chunk(ci, text)
            w.close()
        if hosts > 1:
            pkg.merge_output(str(d / "out.sam"), hosts, header)
    jd, pd = tmp_path / "rabbitsalign_tpu", tmp_path / "rabbitsalign_tpu_torch"
    names = sorted(f.name for f in jd.iterdir())
    assert names == sorted(f.name for f in pd.iterdir())
    assert len(names) == (1 if hosts == 1 else 1 + 2 * hosts)
    for name in names:
        assert (pd / name).read_bytes() == (jd / name).read_bytes(), name
    body = b"".join(t if isinstance(t, bytes) else t.encode() for _, t in chunks)
    assert (pd / "out.sam").read_bytes() == (header.encode() if hosts > 1 else b"") + body


# --- the gloo process group ------------------------------------------------

_PSUM = """
import json, sys
from rabbitsalign_tpu_torch.parallel import multihost as m
if sys.argv[1] == "env":
    rank, world = m.init_distributed()
else:
    rank, world = m.init_distributed(sys.argv[1], 2, int(sys.argv[2]))
total = m.psum_statistics({"n_reads": 1000 * (rank + 1), "feed_miss": 0, "b": rank + 0.5})
m.barrier()
m.shutdown_distributed()
print(json.dumps([rank, world, total]))
"""


@pytest.mark.parametrize("rendezvous", ["tcp", "env"])
def test_psum_statistics_over_two_gloo_processes(tmp_path, rendezvous):
    """Two processes form the group (--coordinator's tcp:// address, or
    the env:// variables), sum their statistics and pass the barrier."""
    port = _free_port()
    cmds, envs = [], []
    for rank in (0, 1):
        if rendezvous == "tcp":
            cmds.append([sys.executable, "-c", _PSUM, f"127.0.0.1:{port}", str(rank)])
            envs.append(_child_env())
        else:
            cmds.append([sys.executable, "-c", _PSUM, "env"])
            envs.append(_child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                                   WORLD_SIZE="2", RANK=str(rank)))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=tmp_path,
                              env=e) for c, e in zip(cmds, envs)]
    got = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
        got.append(json.loads(out.decode().strip().splitlines()[-1]))
    want = {"b": 2.0, "feed_miss": 0.0, "n_reads": 3000.0}
    assert got == [[0, 2, want], [1, 2, want]]


def test_one_process_is_no_pod():
    """One process forms no group: rank 0 of 1, the statistics as given,
    and the barrier and the teardown do nothing."""
    assert pmh.init_distributed(None, 1, 0) == (0, 1)
    stats = {"n_reads": 7, "feed_miss": 0}
    assert pmh.psum_statistics(stats) == stats
    pmh.barrier()
    pmh.shutdown_distributed()


# --- the pod-split index -----------------------------------------------------

def _empty_first_stub():
    """A run of one hash over most entries from the start: the cut of two
    hosts falls back to 0, so host 0's slice is empty, and keys below the
    smallest hash still route to it."""
    hashes = np.concatenate([np.repeat(np.uint64(3) << np.uint64(50), 9),
                             np.repeat(np.uint64(9) << np.uint64(58), 3)])
    n = hashes.shape[0]
    return _Stub(hashes, np.arange(n, dtype=np.uint32) * 7, np.arange(n, dtype=np.uint32) | 256,
                 3, 5)


@pytest.fixture(scope="module")
def world_index():
    genome, _, _, jax_index = _repetitive_world()
    refs = References()
    refs.add("chrR", genome.encode())
    return _port_index(refs, jax_index), jax_index


POD_CASES = {
    # name: (hosts, which index)
    "world": (2, "world"),
    "sentinel": (2, "sentinel"),  # the 0xFF..F run on the top slice
    "sentinel-4": (4, "sentinel"),  # slice 2 empty, between two others
    "empty-first": (2, "empty-first"),  # slice 0 empty, still routed to
}


@pytest.fixture(scope="module")
def pods(world_index):
    """For each case: the port's and the JAX package's pods (every host in
    this process, each serving on a port of its own), and the port's
    one-shard index of the same arrays."""
    made = {}
    for name, (hosts, which) in POD_CASES.items():
        if which == "world":
            port_ix, jax_ix = world_index
        else:
            port_ix = jax_ix = _sentinel_stub() if which == "sentinel" else _empty_first_stub()
        pp = [f"127.0.0.1:{_free_port()}" for _ in range(hosts)]
        jp = [f"127.0.0.1:{_free_port()}" for _ in range(hosts)]
        made[name] = (port_ix,
                      [pmh.PodShardedIndex(port_ix, p, hosts, pp, device="cpu")
                       for p in range(hosts)],
                      [jmh.PodShardedIndex(jax_ix, p, hosts, jp) for p in range(hosts)],
                      psh.ShardedIndex(psh.make_mesh(1, "cpu"), port_ix))
    yield made
    for _, port_pods, jax_pods, _ in made.values():
        for pod in port_pods + jax_pods:
            pod.close()


def _compact(res, cap):
    """The compaction `find_runs_compact` promises, of a dense lookup:
    the walked keys (found, count <= cap) and their rows back to back."""
    cnt = res["count"]
    walk = (cnt > 0) & (cnt <= cap)
    width = np.where(walk, cnt, 0)
    ends = np.cumsum(width)
    rows = np.arange(cap)[None, :] < width[:, None]
    run_pos = res["run_positions"][rows]
    run_packed = res["run_packed"][rows]
    return {"count": cnt, "filtered": res["filtered"],
            "run_off": np.where(walk, ends - width, -1).astype(np.int64),
            "run_positions": run_pos if run_pos.size else np.zeros(1, np.uint32),
            "run_packed": run_packed if run_packed.size else np.zeros(1, np.uint32)}


def _owner(jax_pod, keys):
    """The owning host of each key by the JAX package's routing table."""
    owner = np.searchsorted(jax_pod._start_hash, keys, side="right") - 1
    return jax_pod._route_nonempty[np.clip(owner, 0, jax_pod.nprocs - 1)]


def _key_sets(index, jax_pod):
    rng = np.random.RandomState(11)
    h = np.asarray(index.hashes)
    mixed = _keys(index, rng) if h.shape[0] < 1000 else np.concatenate(
        [h[rng.randint(0, h.shape[0], 400)], rng.randint(0, 2**63, 100).astype(np.uint64),
         np.array([0, TOP, h[0], h[-1]], np.uint64)])
    owner = _owner(jax_pod, mixed)
    return {
        "mixed": mixed,
        "misses": rng.randint(0, 2**63, 64).astype(np.uint64) * np.uint64(2) + np.uint64(1),
        "sentinel": np.full(3, TOP),
        "smallest": np.array([h[0], h[0]], np.uint64),
        "local": mixed[owner == jax_pod.pid],
        "remote": mixed[owner != jax_pod.pid],
        "empty": np.zeros(0, np.uint64),
    }


KEY_SETS = ["mixed", "misses", "sentinel", "smallest", "local", "remote", "empty"]


@pytest.mark.parametrize("keyset", KEY_SETS)
@pytest.mark.parametrize("case", list(POD_CASES))
def test_pod_index_matches_jax_and_one_shard(pods, case, keyset):
    """Every host's `find_runs_compact` at caps 1, the filter cutoff and
    1000 equals the compacted JAX `find_runs_routed` of the same host and
    the one-shard index's; `find_runs_routed` equals the JAX one; and the
    traffic counters move as the JAX package's (remote exchanges only for
    keys another host owns)."""
    index, port_pods, jax_pods, one = pods[case]
    for pod, jpod in zip(port_pods, jax_pods):
        keys = _key_sets(index, jpod)[keyset]
        for cap in (1, one.filter_cutoff, 1000):
            before = dict(pod.stats), dict(jpod.stats)
            got = pod.find_runs_compact(keys, cap)
            want = jpod.find_runs_routed(keys, cap)
            delta = [{k: s[k] - b[k] for k in jpod.stats}  # the JAX package's counters
                     for s, b in zip((pod.stats, jpod.stats), before)]
            assert delta[0] == delta[1]
            _assert_compact_equal(got, _compact(want, cap))
            _assert_compact_equal(got, one.find_runs_compact(keys, cap))
            dense = pod.find_runs_routed(keys, cap)
            for k, w in want.items():
                assert dense[k].dtype == w.dtype, k
                np.testing.assert_array_equal(dense[k], w, err_msg=k)
        if keyset == "local":
            assert delta[0]["remote_batches"] == 0
        if keyset == "remote":  # one exchange with each owner
            assert delta[0]["remote_batches"] == np.unique(_owner(jpod, keys)).size
    if keyset == "sentinel" and case.startswith("sentinel"):
        # found on the top slice, with its run only (no padding counted)
        assert (got["count"] == 10).all() and (got["run_off"] == [0, 10, 20]).all()
    if keyset == "mixed":
        assert (got["count"] > 0).any() and (got["count"] == 0).any()


def test_empty_slices_are_empty(pods):
    """The stub cases' cuts: an empty slice holds nothing and is padded
    with one sentinel entry; every randstrobe is on exactly one host."""
    for case in POD_CASES:
        index, port_pods, _, _ = pods[case]
        assert sum(p.size for p in port_pods) == index.hashes.shape[0]
    assert [p.size for p in pods["empty-first"][1]] == [0, 12]
    assert [p.size for p in pods["sentinel-4"][1]][2] == 0
    assert pods["empty-first"][1][0]._h.numel() == 1


def test_pod_bucket_table_is_trimmed(pods):
    """Each host keeps only the bucket table's rows of its slice's top-bits
    range, as the JAX pod does: the same length and first row, and the
    same bounds once clipped to the slice."""
    for case in POD_CASES:
        index, port_pods, jax_pods, _ = pods[case]
        for pod, jpod in zip(port_pods, jax_pods):
            table = pod._buckets.numpy()
            assert table.shape == jpod._bt.shape and pod.top0 == jpod._top0
            lo = pod.start
            np.testing.assert_array_equal(np.clip(table, lo, lo + pod.size) - lo, jpod._bt)
    world = pods["world"][1]
    full = (1 << world[0].bits) + 1
    assert all(2 <= p._buckets.numel() < full for p in world)
    assert sum(p._buckets.numel() for p in world) <= full + len(world)


def test_pod_index_close_frees_its_ports(world_index):
    """close() ends the server and its connections: a new pod binds the
    same ports and answers across them again. Each host's `k()` is the
    index's, and `find_runs` is the JAX package's alias of
    `find_runs_routed`."""
    index, _ = world_index
    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    keys = np.asarray(index.hashes)[97::97]  # not the smallest hash (the bucket quirk)
    for _ in range(2):
        pods = [pmh.PodShardedIndex(index, p, 2, peers, device="cpu") for p in range(2)]
        try:
            assert [pod.k() for pod in pods] == [index.k()] * 2
            res = pods[0].find_runs_compact(keys)
            assert pods[0].stats["remote_keys"] > 0 and (res["count"] > 0).all()
            dense, routed = pods[0].find_runs(keys, 4), pods[0].find_runs_routed(keys, 4)
            for k, v in routed.items():
                np.testing.assert_array_equal(dense[k], v, err_msg=k)
            assert pods[0].stats["remote_s"] > 0 and pods[1].stats["served_s"] > 0
            served = list(pods[1]._served.values())  # the connection's server thread
        finally:
            for pod in pods:
                pod.close()
        assert len(served) == 1 and not served[0].is_alive()
        assert not any(pod._server.is_alive() for pod in pods)


def test_pod_index_defaults_to_the_card(world_index, monkeypatch):
    """A PodShardedIndex built without a device asks for the card: on a
    machine without one it raises the device check's "no CUDA device"
    error before it opens a socket, and its port stays free."""
    import torch

    index, _ = world_index
    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opened = []
    real_socket = pmh.socket.socket
    monkeypatch.setattr(pmh.socket, "socket", lambda *a, **kw: opened.append(a) or
                        real_socket(*a, **kw))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmh.PodShardedIndex(index, 0, 2, peers)
    assert opened == []
    monkeypatch.undo()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", int(peers[0].rsplit(":", 1)[1])))


def test_pod_index_counts_served_time_before_replying(world_index):
    """The server adds a lookup's time to `served_s` before its reply
    leaves: right after each of 50 lookups the requester holds, the peer's
    counter has grown (and the requester's own `remote_s` with it)."""
    index, _ = world_index
    peers = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    keys = np.asarray(index.hashes)[97::97]
    pods = [pmh.PodShardedIndex(index, p, 2, peers, device="cpu") for p in range(2)]
    try:
        for _ in range(50):
            served, remote = pods[1].stats["served_s"], pods[0].stats["remote_s"]
            pods[0].find_runs_compact(keys)
            assert pods[1].stats["served_s"] > served and pods[0].stats["remote_s"] > remote
    finally:
        for pod in pods:
            pod.close()


def test_cli_help_names_the_pod_dial_budgets(capsys):
    """--pod-index-peers' help names both dial budgets of
    `PodShardedIndex._connect` with their defaults."""
    try:
        port_main(["--help"])
    except SystemExit:
        pass
    text = " ".join(capsys.readouterr().out.split())
    assert "RSB_POD_CONNECT_TIMEOUT seconds (600)" in text
    assert "RSB_POD_REDIAL_TIMEOUT seconds (5)" in text


# --- the CLI, two processes --------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 120 kbp genome, 800 SE reads (a third with a 1-3 bp deletion:
    extend jobs, enough a chunk of 160 for a device dispatch; a 17th
    unmappable: rescue lookups cross hosts) and 300 PE pairs."""
    d = tmp_path_factory.mktemp("torch_pod")
    r = random.Random(23)
    genome = random_dna(120_000, seed=23)
    (d / "ref.fa").write_text(">chrS\n" + genome + "\n")

    def read_at(st, deletion=0):
        a = list(genome[st:st + 75] + genome[st + 75 + deletion:st + 150 + deletion])
        for _ in range(r.randrange(0, 4)):
            a[r.randrange(150)] = r.choice("ACGT")
        return "".join(a)

    def rc(s):
        return "".join(COMP[c] for c in reversed(s))

    with open(d / "se.fq", "w") as f:
        for i in range(800):
            rd = read_at(r.randrange(0, len(genome) - 200), r.randrange(1, 4) if i % 3 == 1 else 0)
            if i % 4 == 2:
                rd = rc(rd)
            if i % 17 == 5:
                rd = "".join(r.choice("ACGT") for _ in range(150))
            f.write(f"@s{i}\n{rd}\n+\n{'I' * 150}\n")
    with open(d / "r1.fq", "w") as f1, open(d / "r2.fq", "w") as f2:
        for i in range(300):
            st = r.randrange(0, len(genome) - 900)
            ins = max(180, min(600, int(r.gauss(300, 40))))
            f1.write(f"@p{i}/1\n{read_at(st, 2 if i % 6 == 1 else 0)}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}/2\n{rc(read_at(st + ins - 150))}\n+\n{'I' * 150}\n")
    return d


def _without_pg(path) -> bytes:
    return b"".join(line for line in open(path, "rb") if not line.startswith(b"@PG"))


def _pod_argv(module, out, node, coord, extra, files):
    start = ["-c", JAX_POD_CHILD] if module == "rabbitsalign_tpu.cli" else ["-m", module]
    return [sys.executable, *start, *extra, "-o", str(out), "--num-nodes", "2",
            "--node-id", str(node), "--coordinator", coord, *map(str, files)]


COMMON = ["--chunk-size", "160", "--tpu-batch", "64"]
_SINGLE = {}  # the single-process outputs of each set of flags


def _single_runs(data, files, extra):
    """(the port's, the JAX package's) single-process output without @PG,
    made once for each set of flags."""
    key = tuple(extra)
    if key not in _SINGLE:
        argv = [*map(str, files), *COMMON, *extra, "-t", "1"]
        outs = [data / f"single{len(_SINGLE)}.{pkg}" for pkg in ("port", "jax")]
        assert port_main(argv + ["--device", "cpu", "-o", str(outs[0])]) == 0
        assert jax_main(argv + ["-o", str(outs[1])]) == 0
        _SINGLE[key] = tuple(_without_pg(o) for o in outs)
    return _SINGLE[key]
POD_MODES = {
    "se-sam": [],
    "se-paf": ["-x"],
    "se-pod-index": ["--pod-index-peers"],
    "se-no-tpu": ["--no-tpu"],
}


@pytest.mark.parametrize("mode", list(POD_MODES))
def test_pod_cli_matches_single_process_and_jax(data, tmp_path, mode, capsys):
    """Two `python -m rabbitsalign_tpu_torch.cli --device cpu --num-nodes
    2` processes: the merged output equals the port's single-process run
    and the JAX package's CLI apart from @PG; each host logs its share and
    the pod total, and under --pod-index-peers no feed miss and its
    lookups crossing to the other host."""
    extra = [f for f in POD_MODES[mode] if f != "--pod-index-peers"]
    files = [data / "ref.fa", data / "se.fq"]
    pod_flags = list(extra)
    if "--pod-index-peers" in POD_MODES[mode]:
        pod_flags += ["--pod-index-peers",
                      ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))]
    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "pod.out"
    logs = _run_all([_pod_argv("rabbitsalign_tpu_torch.cli", out, n, coord,
                               ["--device", "cpu", "-v", *COMMON, *pod_flags], files)
                     for n in (0, 1)], cwd=tmp_path)
    port, jax = _single_runs(data, files, extra)
    capsys.readouterr()
    merged = _without_pg(out)
    assert merged == port
    assert merged == jax
    assert len(merged.splitlines()) >= (700 if "-x" in extra else 800)  # PAF: mapped only
    shares = []
    for node, (_, err) in enumerate(logs):
        line = [ln for ln in err.splitlines() if ln.startswith(f"Host {node}/2: mapped ")]
        assert len(line) == 1 and line[0].endswith("pod total 800"), err[-2000:]
        shares.append(int(line[0].split()[3]))
        launches = json.loads(err.split(f"Host {node}/2 kernel launches: ")[1].splitlines()[0])
        # SAM on the device path extends on it; PAF maps without alignment
        extends = "--no-tpu" not in extra and "-x" not in extra
        assert (launches["extend_dispatches"] > 0) == extends, launches
        if "--pod-index-peers" in pod_flags:
            assert "feed misses 0" in err
            traffic = json.loads(err.split(f"Pod index traffic of host {node}: ")[1]
                                 .splitlines()[0])
            assert traffic["remote_keys"] > 0
    assert sum(shares) == 800 and min(shares) > 0
    assert ("Merged 2 output shards" in logs[0][1]) and ("Merged" not in logs[1][1])
    assert len(list(tmp_path.glob("pod.out.part*of2"))) == 2  # the parts stay beside -o


def test_pe_pod_matches_jax_pod(data, tmp_path):
    """PE insert-size state is per host, so a PE pod run is not the
    single-host run's bytes; the port's two-process pod (--device cpu)
    equals the JAX package's two-process pod (its default device path on
    the CPU), its CLI run with its prewarm held until the host has joined
    the pod (JAX_POD_CHILD)."""
    files = [data / "ref.fa", data / "r1.fq", data / "r2.fq"]
    runs = {}
    for module, flags in (("rabbitsalign_tpu_torch.cli", ["--device", "cpu"]),
                          ("rabbitsalign_tpu.cli", [])):
        coord = f"127.0.0.1:{_free_port()}"
        out = tmp_path / f"{module}.sam"
        _run_all([_pod_argv(module, out, n, coord, [*flags, *COMMON], files) for n in (0, 1)],
                 cwd=tmp_path)
        runs[module] = _without_pg(out)
    assert runs["rabbitsalign_tpu_torch.cli"] == runs["rabbitsalign_tpu.cli"]
    assert len(runs["rabbitsalign_tpu.cli"].splitlines()) >= 600
