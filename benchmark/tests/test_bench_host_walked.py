"""`host_walked_per_kread`, the per-layer metric of phase A's run walk:
read from a fake pipeline's counters as run.py hands them to the
readers (the records the engine walked on the host a thousand reads, and
nothing, without an error, where the program has no such counter), its
entry in BENCHMARK.json, and a traced CPU dry run of a cell, with the
seeding and the walk in their plain versions, that reports it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from .helpers import last_json, load_run, manifest, on_path, tiny

NAME = "host_walked_per_kread"


def _read(reads: int, counters: dict):
    on_path()
    from benchmark.run import metric_reader

    return metric_reader(NAME)(SimpleNamespace(reads=reads, timers={}, counters=counters))


@pytest.mark.parametrize("walked,reads,value", [(240, 1_200_000, 0.2), (0, 1000, 0.0),
                                                (1_000_000, 1_000_000, 1000.0)],
                         ids=["device-walk", "none-left", "host-walk"])
def test_value_from_the_counter(walked, reads, value):
    """The tie rows, long reads and overflows a thousand reads where the
    device walks; 0 where it walked every record; 1000 where the host
    walks every record."""
    counters = {"host_seeded": 200, "host_walked": walked, "chunks": 120}
    assert _read(reads, counters) == pytest.approx(value)


def test_none_without_the_counter():
    """A program without the counter (the parent of the device walk)
    reads nothing, and so does a window without reads."""
    assert _read(1_000_000, {"host_seeded": 240, "chunks": 120}) is None
    assert _read(0, {"host_walked": 5}) is None


def test_manifest_entry():
    """Host phase A's, a program counter, lower is better, moves
    `reads_per_s`, no cell list: every cell reports it."""
    entry = {m["name"]: m for m in manifest()["per_layer"]}[NAME]
    assert entry == {"name": NAME, "unit": "records/kread", "better": "lower",
                     "source": "program_counter", "layer": "host phase A",
                     "moves": "reads_per_s"}


def test_traced_dry_run_reports_it(capsys):
    """A traced run of `chr21-pe150` on the CPU at the tests' size with
    the seeding and run walk in their plain versions (`device_seed`):
    the line reports the metric, the engine walked at most the tie and
    long reads and the overflows on the host, and the run is correct."""
    cell = "chr21-pe150"
    over = tiny(cell)
    over["options"] = {**over["options"], "device_seed": True}
    rc = load_run().main(["--workload", cell, "--seed", str(2 ** 31 + 2207), "--seconds", "2",
                          "--trace", "1"], device="cpu", overrides=over)
    assert rc == 0
    result = last_json(capsys.readouterr().out)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics[NAME]["unit"] == "records/kread"
    assert 0 <= metrics[NAME]["value"] <= 5
    assert metrics[NAME]["value"] >= metrics["host_seeded_per_kread"]["value"]
