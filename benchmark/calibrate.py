#!/usr/bin/env python3
"""The control of a cell's check, at the cell's own size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's genome and read pool, draws as many
reads as a run checks, puts the plain reference in the program's place
computed in int8 (`judge.control_sam`), and judges its records as a run
judges the program's. It prints one JSON line a seed with the numbers
compared; their smallest is a limit's upper reading (PERF.md). It needs
neither the program nor a card; the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(config: dict, mix: dict, seed: int, chunk_size: int, dtype_name: str) -> dict:
    import numpy as np

    from benchmark.reference.align import Scoring
    from benchmark.reference.judge import (Judge, control_sam, draw_samples, parse_sam,
                                           primary_by_read)
    from benchmark.traffic import generate

    genome_rng, pool_rng = generate.streams(seed)
    genome = generate.make_genome(config["contigs"], genome_rng)
    mix = {**mix, "chunk_size": chunk_size}
    pool = generate.make_pool(genome, config["contigs"], mix, pool_rng)
    judge = Judge(pool, genome, [n for n, _ in config["contigs"]], Scoring(),
                  int(mix.get("insert_clip", [0, 0])[1]))
    # the reads a run would draw: as many, drawn alike, from every chunk of the pool
    n_chunks = -(-len(pool) // pool.chunk_reads)
    picked = draw_samples(dict.fromkeys(range(n_chunks), b""), n_chunks, pool.chunk_reads, len(pool),
                          int(mix["check_reads"]), pool.paired,
                          np.random.default_rng([seed, 2]))
    rows = [r for r, _ in picked]
    sam = control_sam(judge, np.asarray(rows), getattr(np, dtype_name))
    found = primary_by_read(parse_sam(sam), pool.paired)
    verdict = judge.judge([(r, found.get(r)) for r in rows])
    return {**verdict.numbers(), "reasons": verdict.reasons,
            "score_gap_max": verdict.score_gap_max, "checked_reads": len(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--dtype", default="int8", help="the control's integer type")
    args = p.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    config = json.loads((ROOT / "benchmark" / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "mixes" / f"{cell['traffic']}.json").read_text())
    chunk_size = int(config.get("options", {}).get("chunk_size", 10000))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_numbers(config, mix, seed, chunk_size, args.dtype)
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
