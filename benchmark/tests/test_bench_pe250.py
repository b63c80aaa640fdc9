"""The cell of 2x250 reads, `chr21-pe250` (configuration
`grch38-chr21-r250`, mix `pe250`): a CPU dry run at a cut size that keeps
the configuration's `{"r": 250}` comes out correct and reports
`tight_job_share`; the control fails the cell's limits; its files and
entries; and the three metrics it brings (`tight_job_share`,
`sw_forward_roofline_pe250`, `sw_traceback_roofline_pe250`), read from a
fake run's counters, jobs and trace, and None where a program lacks
what they read."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest

from .helpers import BENCH, ROOT, manifest, on_path

CELL = "chr21-pe250"
NEW_METRICS = ("tight_job_share", "sw_forward_roofline_pe250", "sw_traceback_roofline_pe250")
# the CPU tests' cut (helpers.tiny), with the configuration's options kept
CUT = {"contigs": [["chr21", 1_500_000]], "options": {"r": 250, "chunk_size": 500},
       "reads": 4000, "check_reads": 400, "keep_share": 1.0}
ARGS = ["--workload", CELL, "--seed", str(2 ** 33 + 2501), "--seconds", "3", "--trace", "1"]
DRY = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.helpers import load_run
sys.exit(load_run().main({ARGS!r}, device="cpu", overrides={CUT!r}))
"""


def _read(name: str, **ctx):
    on_path()
    from benchmark.run import metric_reader

    return metric_reader(name)(SimpleNamespace(**ctx))


@pytest.fixture(scope="module")
def dry():
    out = subprocess.run([sys.executable, "-c", DRY], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dry_run_is_correct_and_reports_the_tight_share(dry):
    assert dry["correct"] is True and dry["failed"] == 0 and dry["attempted"] > 0
    metrics = dry["metrics"]
    # the extend jobs of 250-base reads under the 250 profile are (256, 360) ones,
    # but for a rare rescue window wider than 360 bases
    assert metrics["tight_job_share"]["unit"] == "%"
    assert 98.0 < metrics["tight_job_share"]["value"] <= 100.0
    # the seeding runs on the host here: the CPU has no card
    assert metrics["host_seeded_per_kread"]["value"] == 1000.0
    # the CPU has no device trace: the rooflines stay out
    assert not {"sw_forward_roofline_pe250", "sw_traceback_roofline_pe250"} & set(metrics)
    assert all(c["value"] <= c["limit"] for c in dry["check"].values())


def test_control_is_incorrect():
    """The reference in int8 in the program's place fails the cell's
    limits, at a cut genome and pool, with the cell's mix."""
    on_path()
    from benchmark.calibrate import control_numbers

    mix = json.loads((BENCH / "mixes" / "pe250.json").read_text())
    mix.update(reads=4000, check_reads=600)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    out = control_numbers({"contigs": [["c1", 600_000]]}, mix, 2 ** 32 + 5, 500, "int8")
    assert out["wrong_share"] > limits["wrong_share"]
    assert out["score_gap_share"] > limits["score_gap_share"]
    assert out["replay_errors"] > limits["replay_errors"]


def test_cell_configuration_and_mix():
    m = manifest()
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("grch38-chr21-r250", "pe250", 1)
    entry = {c["name"]: c for c in m["configs"]}["grch38-chr21-r250"]
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["options"] == {"r": 250} and config["source"] == entry["source"]
    assert config["contigs"] == [["chr21", 40_000_000]]
    assert set(entry["reduced"]) == {"contigs", "sequence"}
    mix = json.loads((BENCH / "mixes" / "pe250.json").read_text())
    assert (mix["paired"], mix["read_len"], mix["reads"]) == (True, 250, 240_000)
    assert (mix["insert_mean"], mix["insert_sd"], mix["insert_clip"]) == (550, 100, [300, 1000])
    assert mix["subs_range"] == [0, 5] and mix["random_mate_every"] == 50
    assert (mix["deletion_every"], mix["deletion_len"], mix["deletion_at"]) == (12, [1, 5],
                                                                               [40, 200])
    assert mix["check_reads"] == 6000
    for key in ("insert_mean", "subs_range", "deletion_every", "random_mate_every"):
        assert any(a.startswith("pe250 ") and key in a for a in config["assumed"]), key


@pytest.mark.parametrize("name", NEW_METRICS)
def test_manifest_entries(name):
    entry = {m["name"]: m for m in manifest()["per_layer"]}[name]
    assert entry["moves"] == "reads_per_s" and entry["unit"] == "%"
    assert entry["better"] == "higher"
    if name == "tight_job_share":
        assert entry["layer"] == "extend dispatch" and entry["source"] == "program_counter"
        assert "workloads" not in entry
    else:
        assert entry["layer"] == "kernels" and entry["source"] == "device_trace"
        assert entry["workloads"] == [CELL]


def test_tight_job_share_reader():
    assert _read("tight_job_share", counters={"tight_jobs": 855, "planned_jobs": 857}) == \
        pytest.approx(100.0 * 855 / 857)
    assert _read("tight_job_share", counters={"tight_jobs": 0, "planned_jobs": 12}) == 0.0
    # a program without the counters (the parent), or one that planned nothing
    assert _read("tight_job_share", counters={"small_to_host": 3, "unbucketed": 1}) is None
    assert _read("tight_job_share", counters={"tight_jobs": 0, "planned_jobs": 0}) is None


class _Trace:
    def __init__(self, times: dict):
        self.times = times

    def kernel_time(self, name: str) -> float:
        return self.times.get(name, 0.0)


@pytest.mark.parametrize("kind", ["forward", "traceback"])
def test_roofline_readers_read_as_the_accepted_ones(kind):
    """Each reads what `sw_<kind>_roofline` reads from the same run, a
    share in (0, 100] for a kernel at or above its bound, and None
    without a trace, without jobs or without the kernel in the trace."""
    name, base = f"sw_{kind}_roofline_pe250", f"sw_{kind}_roofline"
    jobs = SimpleNamespace(jobs=1024, cells=1024 * 250 * 330, code_bytes=1024 * 580)
    trace = _Trace({"sw_forward": 0.012, "sw_traceback": 0.004})
    value = _read(name, trace=trace, jobs=jobs)
    assert value == _read(base, trace=trace, jobs=jobs)
    assert math.isfinite(value) and 0 < value <= 100
    assert _read(name, trace=None, jobs=jobs) is None
    assert _read(name, trace=trace, jobs=SimpleNamespace(jobs=0, cells=0, code_bytes=0)) is None
    assert _read(name, trace=_Trace({}), jobs=jobs) is None
