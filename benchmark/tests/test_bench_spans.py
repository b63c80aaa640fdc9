"""The per-layer metrics read from the program's own spans and counters
(`input_wait_us_per_read`, `extend_dispatch_us_per_read`,
`device_wait_us_per_read`, `emit_us_per_read`,
`host_extend_jobs_per_kread`, `upload_bytes_per_read`,
`device_results_us_per_read`, `chunk_out_us_per_read`): a CPU dry run
with `--trace 1` reports each as a finite number >= 0, a `--trace 0` run
still reports only the end-to-end metrics, and each reader returns None
where the program has no such timer or counter."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest

from .helpers import ROOT, manifest

SPAN_METRICS = ("input_wait_us_per_read", "extend_dispatch_us_per_read",
                "device_wait_us_per_read", "emit_us_per_read", "host_extend_jobs_per_kread",
                "upload_bytes_per_read", "device_results_us_per_read", "chunk_out_us_per_read")
ARGS = ["--workload", "chr21-pe150", "--seed", str(2 ** 32 + 1919), "--seconds", "3"]
DRY = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.helpers import load_run, tiny
sys.exit(load_run().main({ARGS!r} + ["--trace", sys.argv[1]], device="cpu",
                         overrides=tiny("chr21-pe150")))
"""


@pytest.fixture(scope="module", params=["0", "1"])
def dry(request):
    """A dry run on the CPU in a fresh interpreter: (result line, trace)."""
    out = subprocess.run([sys.executable, "-c", DRY, request.param], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), request.param


def test_span_metrics_in_the_traced_line(dry):
    result, trace = dry
    metrics = result["metrics"]
    if trace == "0":
        assert set(metrics) == {"reads_per_s", "setup_s"}
        return
    per_layer = {m["name"]: m for m in manifest()["per_layer"]}
    for name in SPAN_METRICS:
        assert name in metrics, name
        value = metrics[name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
        assert metrics[name]["unit"] == per_layer[name]["unit"]
    # the dispatch span runs for every chunk, with device work or without,
    # and every chunk's output is copied out
    assert metrics["extend_dispatch_us_per_read"]["value"] > 0
    assert metrics["chunk_out_us_per_read"]["value"] > 0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_returns_none_without_the_program_key(name):
    """A program without the spans and counters (the parent of the change
    that added them) gives no value and no error."""
    from benchmark.run import metric_reader

    read = metric_reader(name)
    older = SimpleNamespace(reads=1000, timers={"phase_a_s": 1.0, "phase_b_s": 0.5},
                            counters={"fallbacks": 3, "aligner_calls": 10})
    assert read(older) is None
    assert read(SimpleNamespace(reads=0, timers={}, counters={})) is None
