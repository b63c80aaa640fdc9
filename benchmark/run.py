#!/usr/bin/env python3
"""The benchmark of rabbitsalign_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a
configuration (benchmark/configs/<name>.json: the genome's contigs and
the CLI options of the deployment) and a traffic mix
(benchmark/mixes/<name>.json: the read model). The run

1. makes the genome and the read pool from the seed;
2. builds the index in memory and the CLI's default pipeline
   (`ThreadedNativePipeline`, device extend), and warms it on a few
   chunks;
3. streams the pool, cycled, through a named pipe into
   `ThreadedNativePipeline.map_file` for `--seconds`, and lets it drain;
4. judges a sample of the emitted records against the plain reference
   (benchmark/reference/), once the program's state is freed;
5. prints the numbers compared beside their limits on stderr, and one
   JSON result line last on stdout: the cell's end-to-end metrics, or
   with `--trace 1` its per-layer metrics (benchmark/metrics/<name>.py
   each) read from a torch.profiler trace of the window, the program's
   timers and counters.

It needs a CUDA card and refuses to run without one. The kernel library
builds into the package's own build/ directory and the engine into
benchmark/_cache/, both inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules that no run may load: JAX and the JAX package (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "rabbitsalign_tpu")
WARM_CHUNKS_A_WORKER = 2  # warm-up chunks for each mapping worker
KEEP_SHARE = 0.125  # share of the window's chunks kept for the check


def caches() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths."""
    cache = BENCH / "_cache"
    os.environ["RABBITSALIGN_TPU_TORCH_CACHE"] = str(cache / "engine")
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str) -> tuple:
    """(manifest, cell, configuration, mix, limits) of the cell `name`."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return (manifest, cell, load_json(BENCH / "configs" / f"{cell['config']}.json"),
            load_json(BENCH / "mixes" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json"))


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest: dict, cell: dict, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones (all those
    without a `workloads` list, and those that list it), or with a trace
    the per-layer ones that list it or, without a list, move one of its
    end-to-end metrics."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m: dict) -> bool:
        return cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in manifest["per_layer"] if reported(m)]


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device: str = "cuda", overrides: dict = None) -> int:
    """One run. `device` and `overrides` (keys replacing those of the
    configuration and the mix) serve the CPU tests only."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    args.seed %= 1 << 64  # numpy's seeds are non-negative
    manifest, cell, config, mix, limits = cell_files(args.workload)
    for key, value in (overrides or {}).items():
        (config if key in config else mix)[key] = value

    caches()
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"run.py: the cell needs {cell['chips']} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2

    import numpy as np

    from benchmark.harness import system, window
    from benchmark.harness.trace import profiled, read_trace, span
    from benchmark.reference.align import Scoring
    from benchmark.reference.judge import Judge, draw_samples
    from benchmark.traffic import generate

    genome_rng, pool_rng = generate.streams(args.seed)
    genome = generate.make_genome(config["contigs"], genome_rng)
    opt = system.options(config, bool(mix["paired"]))
    mix.setdefault("chunk_size", opt.chunk_size)
    pool = generate.make_pool(genome, config["contigs"], mix, pool_rng)
    chunks = generate.fastq_chunks(pool)
    sut = system.build(config, genome, opt, device)
    pipe = sut.pipeline
    warm = window.run_window(pipe, chunks, pool.chunk_reads, pool.paired, opt.chunk_size,
                             seconds=3600.0, max_chunks=WARM_CHUNKS_A_WORKER * opt.n_threads)
    if warm.n_reads != warm.fed_reads:
        raise RuntimeError(f"warm-up: {warm.fed_reads} reads fed, {warm.n_reads} mapped")
    keep_flags = np.random.default_rng([args.seed, 1]).random(1 << 20) < float(
        mix.get("keep_share", KEEP_SHARE))
    keep_flags[0] = True  # a short window keeps at least its first chunk

    traced: dict = {}
    gc.collect()
    setup_s = time.perf_counter() - T_START
    with window.counting_extend_jobs(bool(args.trace)) as jobs, \
            profiled(bool(args.trace), traced):
        with span("window"):
            res = window.run_window(pipe, chunks, pool.chunk_reads, pool.paired,
                                    opt.chunk_size, args.seconds, keep=keep_flags.__getitem__)
    timers, counters, dispatches = pipe.timers(), pipe.counters(), pipe.dispatches()
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["chips"]),
               "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                            for i in range(int(cell["chips"]))))}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    dtrace = read_trace(traced["events"]) if args.trace else None
    if dtrace is not None:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    ctx = SimpleNamespace(window=res, setup_s=setup_s, index_load_s=sut.index_load_s,
                          timers=timers, counters=counters, dispatches=dispatches,
                          jobs=jobs, trace=dtrace, reads=res.n_reads)

    # the program's state goes before the reference runs
    del sut, pipe, warm
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check: reads drawn from the seed among the kept chunks
    samples = draw_samples(res.kept, len(chunks), pool.chunk_reads, len(pool),
                           int(mix["check_reads"]), pool.paired,
                           np.random.default_rng([args.seed, 2]))
    judge = Judge(pool, genome, [n for n, _ in config["contigs"]], Scoring(
        opt.A, opt.B, opt.O, opt.E, opt.end_bonus), int(mix.get("insert_clip", [0, 0])[1]))
    verdict = judge.judge(samples, int(mix["check_reads"]))
    lost = res.fed_reads - len(res.written) * pool.chunk_reads
    numbers = {**verdict.numbers(), "lost_reads": lost + abs(res.fed_reads - res.n_reads)}
    limit_of = {**limits, "lost_reads": 0}
    correct = all(v <= limit_of[k] for k, v in numbers.items())
    check = {k: {"value": v, "limit": limit_of[k]} for k, v in numbers.items()}

    metrics = {}
    for m in cell_metrics(manifest, cell, bool(args.trace)):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": res.fed_reads, "failed": lost, "metrics": metrics,
              "device": dev}
    if dtrace is not None:
        result["breakdown"] = dtrace.breakdown()
    result["check"] = check

    bad = loaded_forbidden()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    fifths = np.array_split(np.asarray(res.written), 5)
    print("window: %d chunks in %.3f s; reads/s by fifth of the chunks: %s; load average %s"
          % (len(res.written), res.seconds,
             " ".join("%.0f" % (pool.chunk_reads * (len(f) - 1) / (f[-1] - f[0]))
                      for f in fifths if len(f) > 1), os.getloadavg()), file=sys.stderr)
    print(f"check reasons: {json.dumps(verdict.reasons)}; widest score gap "
          f"{verdict.score_gap_max}", file=sys.stderr)
    for k, c in check.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
