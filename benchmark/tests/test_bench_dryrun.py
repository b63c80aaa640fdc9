"""Runs of benchmark/run.py on the CPU at a cut size: the result line's
shape, that no run loads JAX or the JAX package, that a run without a
card refuses, and that a broken timed path comes out not correct. The
last test runs a cell on the card and skips without one."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from .helpers import BENCH, ROOT, last_json, load_run, on_path, tiny

ARGS = ["--workload", "chr21-pe150", "--seed", str(2 ** 31 + 4242), "--seconds", "3"]
DRY = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.helpers import load_run, tiny
run = load_run()
rc = run.main({ARGS!r} + ["--trace", sys.argv[1]], device="cpu", overrides=tiny("chr21-pe150"))
print(json.dumps({{"rc": rc, "modules": sorted(sys.modules)}}))
"""


@pytest.fixture(scope="module", params=["0", "1"])
def dry(request):
    """One dry run on the CPU in a fresh interpreter, with and without
    the trace: (result line, the run's return code, its modules)."""
    out = subprocess.run([sys.executable, "-c", DRY, request.param], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr, request.param


def test_dry_run_prints_a_contract_line(dry):
    result, tail, stderr, trace = dry
    assert tail["rc"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    names = set(result["metrics"])
    if trace == "0":
        assert names == {"reads_per_s", "setup_s"}
    else:
        # the CPU has no device trace: the device metrics stay out
        assert {"phase_a_us_per_read", "extend_batches_per_kread"} <= names
        assert "sw_forward_roofline" not in names and "breakdown" in result
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    for k, c in result["check"].items():
        assert f"check {k}: {c['value']} (limit {c['limit']})" in stderr
    assert stderr.strip().splitlines()[-1].startswith("check ")


def test_dry_run_loads_no_jax(dry):
    tail = dry[1]
    tops = {m.split(".", 1)[0] for m in tail["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "rabbitsalign_tpu"}
    assert "rabbitsalign_tpu_torch" in tops  # whole names: the port's is not the JAX package's


def test_forbidden_names_are_compared_whole(monkeypatch):
    run = load_run()
    monkeypatch.setitem(sys.modules, "rabbitsalign_tpu_torch_x", sys)
    assert "rabbitsalign_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "rabbitsalign_tpu.cli", sys)
    assert "rabbitsalign_tpu" in run.loaded_forbidden()


def test_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert load_run().main(ARGS) != 0
    assert capsys.readouterr().out == ""


def drop_half(text: bytes) -> bytes:
    lines = text.split(b"\n")
    return b"\n".join(lines[: len(lines) // 2]) + b"\n"


def every_tenth(text: bytes, field: int, edit) -> bytes:
    lines = text.split(b"\n")
    for i in range(0, len(lines), 10):
        f = lines[i].split(b"\t")
        if len(f) > field:
            f[field] = edit(f[field])
            lines[i] = b"\t".join(f)
    return b"\n".join(lines)


def alter_answers(text: bytes) -> bytes:
    """AS + 1 in every tenth record that has one."""
    return every_tenth(text, -1, lambda v: b"AS:i:%d" % (int(v[5:]) + 1)
                       if v.startswith(b"AS:i:") else v)


def alter_mate_fields(text: bytes) -> bytes:
    """TLEN + 1 in every tenth record: host phase B's fields."""
    return every_tenth(text, 8, lambda v: b"%d" % (int(v) + 1))


def run_cell(cell: str, capsys, seed: int, **extra) -> dict:
    rc = load_run().main(["--workload", cell, "--seed", str(seed), "--seconds", "2"],
                         device="cpu", overrides={**tiny(cell), **extra})
    assert rc == 0
    return last_json(capsys.readouterr().out)


@pytest.mark.parametrize("cell,fault,number", [
    ("dm6-pe150", drop_half, "wrong_share"),
    ("chr21-se150-indel", drop_half, "wrong_share"),
    ("dm6-pe150", alter_answers, "score_gap_share"),
    ("chr21-se150-indel", alter_answers, "score_gap_share"),
    ("dm6-pe150", alter_mate_fields, "field_errors"),
])
def test_broken_timed_path_is_not_correct(cell, fault, number, monkeypatch, capsys):
    """Half of each chunk's records left out, or answers altered where the
    engine produces them: the run's `correct` comes out false, on the
    number of the layer at fault."""
    on_path()
    from rabbitsalign_tpu_torch.pipeline.native_pipeline import NativePipeline

    finish = NativePipeline.finish_chunk
    monkeypatch.setattr(NativePipeline, "finish_chunk",
                        lambda self, state: fault(finish(self, state)))
    result = run_cell(cell, capsys, 2 ** 31 + 99)
    assert result["correct"] is False
    assert result["check"][number]["value"] > result["check"][number]["limit"]


def test_device_confined_fault_is_not_correct(monkeypatch, capsys):
    """Every score the device extend produces lowered by 2, in a PE cell
    where about one read in a hundred reaches the device: the score gap
    share fails although the whole-record share stays under its limit.
    The chunks are large enough that each plans a device batch (a
    bucket of fewer than the engine's MIN_DEVICE_JOBS stays on the
    host)."""
    on_path()
    from rabbitsalign_tpu_torch.ops import extend_device

    forward = extend_device.sw_forward

    def lowered(*args, **kwargs):
        score, *rest = forward(*args, **kwargs)
        return (score - 2 * (score > 0).to(score.dtype), *rest)

    monkeypatch.setattr(extend_device, "sw_forward", lowered)
    result = run_cell("dm6-pe150", capsys, 2 ** 31 + 77, reads=10000, check_reads=10000,
                      options={"chunk_size": 5000, "n_threads": 1})
    assert result["correct"] is False
    gap, whole = result["check"]["score_gap_share"], result["check"]["wrong_share"]
    assert gap["value"] > gap["limit"] and whole["value"] <= whole["limit"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of the first cell through the benchmark's command."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *ARGS, "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200,
                         env={**os.environ})
    assert out.returncode == 0, out.stderr[-4000:]
    assert last_json(out.stdout)["correct"] is True
