"""Shared pieces of the benchmark's CPU tests: a cell cut to a size that
a CPU test run holds, and the run's entry loaded from its file."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def tiny(cell: str) -> dict:
    """Overrides that cut a cell to a small genome and pool, with every
    chunk of the window kept for the check."""
    contigs = ([["chr21", 1_500_000]] if cell.startswith("chr21")
               else [["chr2L", 800_000], ["chr3R", 700_000]])
    return {"contigs": contigs, "options": {"chunk_size": 500}, "reads": 4000,
            "check_reads": 400, "keep_share": 1.0}


def load_run():
    spec = importlib.util.spec_from_file_location("bench_run", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def on_path() -> None:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
