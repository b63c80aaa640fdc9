"""BENCHMARK.json against the benchmark's contract: names, units,
metrics and their layers, and that every cell finds its files."""

from __future__ import annotations

import re

import pytest

from .helpers import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(one_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    m = manifest()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    for cell in m["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])


def test_end_to_end_metrics():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in e2e.values():
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_what_their_cells_report():
    m = manifest()
    cells = {c["name"] for c in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(x["layer"])
        assert x["moves"] in e2e
        for cell in x.get("workloads", sorted(cells)):
            assert cell in cells
            listed = e2e[x["moves"]].get("workloads")
            assert listed is None or cell in listed


def test_every_cell_reports_enough():
    m = manifest()
    for cell in m["workloads"]:
        e2e = [x["name"] for x in m["end_to_end"]
               if "workloads" not in x or cell["name"] in x["workloads"]]
        layer = [x for x in m["per_layer"]
                 if cell["name"] in x.get("workloads", [cell["name"]]) and x["moves"] in e2e]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell["name"]


def test_configurations():
    m = manifest()
    used = {c["config"] for c in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", [c["name"] for c in manifest()["workloads"]])
def test_cell_files(cell):
    m = manifest()
    c = {x["name"]: x for x in m["workloads"]}[cell]
    assert set(c) == {"name", "config", "traffic", "chips", "why"}
    assert c["chips"] in (1, 4) and one_line(c["why"])
    assert (BENCH / "configs" / f"{c['config']}.json").is_file()
    assert (BENCH / "mixes" / f"{c['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{cell}.json").is_file()
    pairs = [(x["config"], x["traffic"]) for x in m["workloads"]]
    assert pairs.count((c["config"], c["traffic"])) == 1


def test_four_chip_cells_are_few():
    cells = manifest()["workloads"]
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", [x["name"] for x in manifest()["end_to_end"]
                                    + manifest()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert (BENCH / "metrics" / f"{metric}.py").is_file()
