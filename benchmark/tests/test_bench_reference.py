"""The plain reference: its dynamic programme against a brute force,
the CIGAR replay, the judge flagging corrupted records, and the control
(the reference in int8 in the program's place) coming out incorrect."""

from __future__ import annotations

import json
import numpy as np
import pytest

from .helpers import BENCH, on_path

on_path()

from benchmark.calibrate import control_numbers  # noqa: E402
from benchmark.reference.align import Scoring, best_scores, parse_cigar, replay  # noqa: E402
from benchmark.reference.judge import (Judge, control_sam, parse_sam,  # noqa: E402
                                       primary_by_read)
from benchmark.traffic import generate  # noqa: E402

SC = Scoring()


def brute(q, t) -> int:
    """Gotoh's three matrices, cell by cell, for the same objective."""
    n, m, neg = len(q), len(t), -10 ** 9
    H = [[neg] * (m + 1) for _ in range(n + 1)]
    E = [[neg] * (m + 1) for _ in range(n + 1)]
    F = [[neg] * (m + 1) for _ in range(n + 1)]
    H[0] = [SC.end_bonus] * (m + 1)
    best = neg
    for i in range(1, n + 1):
        H[i][0] = 0
        for j in range(1, m + 1):
            E[i][j] = max(H[i - 1][j] - SC.gap_open, E[i - 1][j] - SC.gap_extend)
            F[i][j] = max(H[i][j - 1] - SC.gap_open, F[i][j - 1] - SC.gap_extend)
            s = SC.match if q[i - 1] == t[j - 1] else -SC.mismatch
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j] + (SC.end_bonus if i == n else 0))
    return best


def test_best_scores_match_brute_force():
    rng = np.random.default_rng(1)
    B, n, m = 120, 12, 20
    t = rng.integers(0, 4, (B, m)).astype(np.uint8)
    q = np.empty((B, n), np.uint8)
    for b in range(B):
        seg = list(t[b, rng.integers(0, 5):][: n + 3])
        for _ in range(rng.integers(0, 3)):
            k, op = rng.integers(0, len(seg)), rng.integers(0, 3)
            if op == 0:
                seg[k] = rng.integers(0, 4)
            elif op == 1:
                del seg[k]
            else:
                seg.insert(k, rng.integers(0, 4))
        q[b] = (seg + list(rng.integers(0, 4, n)))[:n]
    assert best_scores(q, t, SC).tolist() == [brute(q[b], t[b]) for b in range(B)]


def test_replay():
    genome = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8)
    seq = np.array([1, 2, 3, 1, 2, 0], np.uint8)  # genome 1..3, skip 0, then 1 2, then X
    got = replay(parse_cigar(b"3M1D3M"), seq, genome, 1, SC)
    # 5 matches, a mismatch, a 1-base deletion, both ends reached
    assert got == (5 * 2 - 8 - 12 + 2 * 10, 2, 6)
    assert replay(parse_cigar(b"2S4M"), seq, genome, 3, SC)[2] == 6
    assert parse_cigar(b"*") is None


def pool_and_judge(mix_name: str, n_reads: int = 600):
    mix = json.loads((BENCH / "mixes" / f"{mix_name}.json").read_text())
    mix.update(reads=n_reads, chunk_size=100)
    genome_rng, pool_rng = generate.streams(2 ** 33 + 7)
    contigs = [["c1", 300_000], ["c2", 200_000]]
    genome = generate.make_genome(contigs, genome_rng)
    pool = generate.make_pool(genome, contigs, mix, pool_rng)
    judge = Judge(pool, genome, ["c1", "c2"], SC, int(mix.get("insert_clip", [0, 0])[1]))
    return pool, judge


def judged(judge, pool, rows, sam: bytes):
    found = primary_by_read(parse_sam(sam), pool.paired)
    return judge.judge([(r, found.get(r)) for r in rows])


def corrupt(sam: bytes, row: int, how) -> bytes:
    lines = sam.split(b"\n")
    f = lines[row].split(b"\t")
    how(f)
    lines[row] = b"\t".join(f)
    return b"\n".join(lines)


def bump_as(f):
    f[-1] = b"AS:i:%d" % (int(f[-1][5:]) + 1)


def shift_pos(f):
    f[3] = b"%d" % (int(f[3]) + 3)


def flip_strand(f):
    f[1] = b"%d" % (int(f[1]) ^ 0x10)


def bad_tlen(f):
    f[8] = b"%d" % (int(f[8]) + 1)


def flip_proper(f):
    f[1] = b"%d" % (int(f[1]) ^ 0x2)


@pytest.mark.parametrize("mix_name,how,reason,number", [
    ("se150-indel", bump_as, "replay", "score_gap_share"),
    ("se150-indel", shift_pos, "replay", "replay_errors"),
    ("se150-indel", flip_strand, "misplaced", "wrong_share"),
    ("pe150", bad_tlen, "mate_fields", "field_errors"),
    ("pe150", flip_proper, "proper", "field_errors"),
])
def test_judge_flags_a_corrupted_record(mix_name, how, reason, number):
    pool, judge = pool_and_judge(mix_name)
    rows = np.arange(len(pool))[: 200]
    sam = control_sam(judge, rows, np.int32)
    clean = judged(judge, pool, rows, sam)
    # the first mapped pair or read: record 0 (mate 1 of pair 0, or read 0)
    row = next(i for i, ln in enumerate(sam.split(b"\n")) if b"AS:i:" in ln)
    bad = judged(judge, pool, rows, corrupt(sam, row, how))
    assert bad.wrong > clean.wrong and bad.reasons.get(reason, 0) > clean.reasons.get(reason, 0)
    assert bad.numbers()[number] > clean.numbers()[number]


def test_judge_flags_a_missing_record():
    pool, judge = pool_and_judge("se150-indel")
    rows = np.arange(100)
    found = primary_by_read(parse_sam(control_sam(judge, rows, np.int32)), False)
    del found[5]
    verdict = judge.judge([(r, found.get(r)) for r in rows])
    assert verdict.reasons == {"missing": 1}


@pytest.mark.parametrize("cell", ["chr21-pe150", "dm6-pe150", "chr21-se150-indel"])
def test_control_is_incorrect(cell):
    """The reference in int8 in the program's place fails the cell's
    limits; at a cut genome and pool, with the cell's mix."""
    m = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    c = {w["name"]: w for w in m["workloads"]}[cell]
    mix = json.loads((BENCH / "mixes" / f"{c['traffic']}.json").read_text())
    mix.update(reads=4000, check_reads=600)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    out = control_numbers({"contigs": [["c1", 600_000]]}, mix, 2 ** 32 + 3, 500, "int8")
    assert out["wrong_share"] > limits["wrong_share"]
    assert out["score_gap_share"] > limits["score_gap_share"]
    assert out["replay_errors"] > limits["replay_errors"]
