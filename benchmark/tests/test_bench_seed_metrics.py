"""The two per-layer metrics of phase A's seeding on the device
(`device_seed_us_per_read`, `host_seeded_per_kread`), read from a fake
pipeline's timers and counters as run.py hands them to the readers: the
values where the card seeds, where the host seeds every record, and
nothing, without an error, where the program has no such timer or
counter or counted no seeding at all."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from .helpers import manifest, on_path

SEED_METRICS = ("device_seed_us_per_read", "host_seeded_per_kread")


def _read(name: str, reads: int, timers: dict, counters: dict):
    on_path()
    from benchmark.run import metric_reader

    return metric_reader(name)(SimpleNamespace(reads=reads, timers=timers, counters=counters))


def test_seeding_on_the_card():
    """3 workers' thread-seconds over 1.2 million reads, 240 records
    (ties and long reads) left to the host."""
    timers = {"phase_a_s": 5.6, "seed_nam_s": 3.1, "device_seed_s": 0.6}
    counters = {"host_seeded": 240, "chunks": 120}
    assert _read("device_seed_us_per_read", 1_200_000, timers, counters) == pytest.approx(0.5)
    assert _read("host_seeded_per_kread", 1_200_000, timers, counters) == pytest.approx(0.2)


def test_seeding_on_the_host():
    """Host seeding: no device time, every record counted."""
    timers = {"phase_a_s": 11.0, "seed_nam_s": 8.4, "device_seed_s": 0.0}
    counters = {"host_seeded": 1_000_000}
    assert _read("device_seed_us_per_read", 1_000_000, timers, counters) == 0.0
    assert _read("host_seeded_per_kread", 1_000_000, timers, counters) == 1000.0


def test_none_where_the_program_counts_no_seeding():
    """A program whose `host_seeded` counted only --device-seed's
    fallbacks, on a run that seeded on the host: 0 and 0, so no reading;
    the device time is still a true 0."""
    timers = {"phase_a_s": 11.0, "device_seed_s": 0.0}
    counters = {"host_seeded": 0, "chunks": 100}
    assert _read("host_seeded_per_kread", 1_000_000, timers, counters) is None
    assert _read("device_seed_us_per_read", 1_000_000, timers, counters) == 0.0


@pytest.mark.parametrize("name", SEED_METRICS)
def test_none_without_the_program_key(name):
    older = ({"phase_a_s": 1.0, "phase_b_s": 0.5}, {"fallbacks": 3, "aligner_calls": 10})
    assert _read(name, 1000, *older) is None
    assert _read(name, 0, {"device_seed_s": 1.0}, {"host_seeded": 5}) is None


@pytest.mark.parametrize("name", SEED_METRICS)
def test_manifest_entry(name):
    """Both are host phase A's, move `reads_per_s`, and have no cell list:
    every cell reports them."""
    entry = {m["name"]: m for m in manifest()["per_layer"]}[name]
    assert entry["layer"] == "host phase A"
    assert entry["moves"] == "reads_per_s"
    assert "workloads" not in entry
    assert entry["source"] == ("program_span" if name.endswith("us_per_read")
                               else "program_counter")
    value = _read(name, 10, {"device_seed_s": 1e-5}, {"host_seeded": 1})
    assert math.isfinite(value) and value > 0
