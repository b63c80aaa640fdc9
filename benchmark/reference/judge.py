"""The comparison that decides `correct`: SAM records that the window
emitted, judged against the plain reference.

For each read drawn for the check, its record must hold:

- host phase A: a read that was cut from the genome is mapped on its
  contig and strand, with its first aligned base where the read starts
  (within `POS_SLACK` bases, past any leading soft clip);
- the extend: its AS equals the reference optimum (`align.best_scores`,
  int32) of the read against the genome around its origin, and its CIGAR,
  replayed along the read and the genome from POS, gives that AS and its
  NM and spans the read;
- host phase B: SEQ is the read, or its reverse complement where the
  flag says so; a pair's flags, RNEXT, PNEXT and TLEN are what the SAM
  rules of the aligner make of the two mates' records, and its proper-pair
  flag is set exactly when both mates map facing each other within the
  mix's largest insert.

A random (unmappable) read may stay unmapped; where it maps, its CIGAR
must replay. Four numbers come out, one for the whole record and one for
each layer that a fault could hide in behind the others:

- `wrong_share`: the share of the drawn reads whose record fails any of
  the above (mostly host phase A's placement, which the aligner misses
  on its own for some cut reads);
- `score_gap_share`: among the cut reads placed at their origin, the
  share whose AS is not the reference optimum (the extend);
- `field_errors`: the reads whose SEQ, flags or mate fields break the
  SAM rules (host phase B);
- `replay_errors`: the records whose CIGAR does not replay to their AS
  and NM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .align import Scoring, best_scores, parse_cigar, ref_span, replay

POS_SLACK = 5  # bases a record's start may lie from the read's origin
WINDOW_PAD = 16  # genome bases around a read's origin that the reference searches
CODE = np.full(256, 4, dtype=np.uint8)
CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

F_PAIRED, F_PROPER, F_UNMAP, F_MUNMAP = 0x1, 0x2, 0x4, 0x8
F_REVERSE, F_MREVERSE, F_READ1, F_READ2 = 0x10, 0x20, 0x40, 0x80
F_SECONDARY, F_SUPPLEMENTARY = 0x100, 0x800
FIELD_REASONS = ("seq", "flags", "mate_fields", "proper")  # what host phase B writes


@dataclass
class Record:
    qname: bytes
    flag: int
    rname: bytes
    pos: int  # 1-based, 0 when none
    cigar: bytes
    rnext: bytes
    pnext: int
    tlen: int
    seq: bytes
    nm: Optional[int]
    as_: Optional[int]

    @property
    def mapped(self) -> bool:
        return not self.flag & F_UNMAP


def parse_sam(text: bytes) -> List[Record]:
    out = []
    for line in text.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        tags = {t[:2]: t[5:] for t in f[11:]}
        out.append(Record(f[0], int(f[1]), f[2], int(f[3]), f[5], f[6], int(f[7]), int(f[8]),
                          f[9], int(tags[b"NM"]) if b"NM" in tags else None,
                          int(tags[b"AS"]) if b"AS" in tags else None))
    return out


def read_index(qname: bytes) -> int:
    """The pool index in a read name ('r12', 'p12')."""
    return int(qname[1:])


@dataclass
class Verdict:
    n_reads: int
    wrong: int
    replay_errors: int
    placed: int = 0  # cut reads placed at their origin
    score_gaps: int = 0  # of those, the reads whose AS is not the optimum
    field_errors: int = 0  # reads with a FIELD_REASONS fault
    reasons: Dict[str, int] = field(default_factory=dict)
    score_gap_max: int = 0  # widest reference optimum - AS among placed reads

    @property
    def wrong_share(self) -> float:
        return self.wrong / self.n_reads if self.n_reads else 1.0

    @property
    def score_gap_share(self) -> float:
        return self.score_gaps / self.placed if self.placed else 1.0

    def numbers(self) -> dict:
        return {"wrong_share": self.wrong_share, "score_gap_share": self.score_gap_share,
                "field_errors": self.field_errors, "replay_errors": self.replay_errors}


def _codes(seq: bytes) -> np.ndarray:
    return CODE[np.frombuffer(seq, dtype=np.uint8)]


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


class Judge:
    """Holds the truth of a pool and the genome it was cut from."""

    def __init__(self, pool, genome: List[np.ndarray], contig_names: List[str],
                 scoring: Scoring, max_insert: int):
        self.pool = pool
        self.genome = genome
        self.names = [n.encode() for n in contig_names]
        self.sc = scoring
        self.max_insert = max_insert

    def optimum(self, rows: np.ndarray, dtype=np.int32) -> np.ndarray:
        """The reference optimum of each pool read in `rows` (all cut
        from the genome) against its origin, padded by WINDOW_PAD."""
        p = self.pool
        L = p.fwd.shape[1]
        m = L + int(p.deletion.max(initial=0)) + 2 * WINDOW_PAD
        win = np.full((len(rows), m), 4, dtype=np.uint8)
        for k, r in enumerate(rows):
            g = self.genome[p.contig[r]]
            a = int(p.start[r]) - WINDOW_PAD
            lo, hi = max(a, 0), min(a + m, len(g))
            win[k, lo - a:hi - a] = g[lo:hi]
        out = np.empty(len(rows), dtype=np.int64)
        for s in range(0, len(rows), 2048):
            out[s:s + 2048] = best_scores(p.fwd[rows[s:s + 2048]], win[s:s + 2048], self.sc, dtype)
        return out

    def _replay(self, rec: Record, reasons: List[str]) -> bool:
        ops = parse_cigar(rec.cigar)
        try:
            contig = self.names.index(rec.rname)
        except ValueError:
            contig = None
        res = None
        if ops is not None and contig is not None and rec.as_ is not None:
            res = replay(ops, _codes(rec.seq), self.genome[contig], rec.pos - 1, self.sc)
        if res is None or res != (rec.as_, rec.nm, len(rec.seq)):
            reasons.append("replay")
            return False
        return True

    def _placed(self, rec: Record, r: int, reasons: List[str]) -> bool:
        p = self.pool
        if not rec.mapped:
            reasons.append("unmapped")
            return False
        ops = parse_cigar(rec.cigar) or [(0, b"M")]
        lead = ops[0][0] if ops[0][1] == b"S" else 0
        if (rec.rname != self.names[p.contig[r]] or bool(rec.flag & F_REVERSE) != bool(p.rc[r])
                or abs(rec.pos - 1 - lead - int(p.start[r])) > POS_SLACK):
            reasons.append("misplaced")
            return False
        return True

    def _seq(self, rec: Record, r: int, reasons: List[str]) -> None:
        as_read = self.pool.fwd[r] if not self.pool.rc[r] else _revcomp(self.pool.fwd[r])
        want = _revcomp(as_read) if rec.mapped and rec.flag & F_REVERSE else as_read
        if not np.array_equal(_codes(rec.seq), want):
            reasons.append("seq")

    def _mate_fields(self, x: Record, y: Record, first: bool, both_real: bool,
                     reasons: List[str]) -> None:
        """x's flags and mate fields given its mate's record y."""
        want = F_PAIRED | (F_READ1 if first else F_READ2)
        if not x.mapped:
            want |= F_UNMAP
        if not y.mapped:
            want |= F_MUNMAP
        if x.mapped and x.flag & F_REVERSE:
            want |= F_REVERSE
        if y.mapped and y.flag & F_REVERSE:
            want |= F_MREVERSE
        mask = ~(F_PROPER | F_SECONDARY | F_SUPPLEMENTARY)
        if (x.flag & mask) != want:
            reasons.append("flags")
        m1, m2 = (x, y) if first else (y, x)
        if x.mapped and y.mapped:
            same = x.rname == y.rname
            fields = (b"=" if same else y.rname, y.pos)
            tlen = 0
            if same:
                dist = m2.pos - m1.pos
                span1 = ref_span(parse_cigar(m1.cigar) or [])
                span2 = ref_span(parse_cigar(m2.cigar) or [])
                tlen = dist + span2 if dist > 0 else dist - span1
                tlen = tlen if first else -tlen
                facing = ((not m1.flag & F_REVERSE and m2.flag & F_REVERSE and dist >= 0)
                          or (m1.flag & F_REVERSE and not m2.flag & F_REVERSE and dist <= 0))
                proper = bool(facing) and abs(dist) <= self.max_insert
            else:
                proper = False
            if both_real and bool(x.flag & F_PROPER) != proper:
                reasons.append("proper")
            got = (x.rnext, x.pnext)
        elif x.mapped:  # mate unmapped: it points back at x
            fields, tlen, got = (b"=", x.pos), 0, (x.rnext, x.pnext)
        elif y.mapped:  # x unmapped, placed at its mate
            fields, tlen = (b"=", y.pos), 0
            got = (x.rnext, x.pnext)
            if (x.rname, x.pos) != (y.rname, y.pos):
                reasons.append("mate_fields")
        else:
            fields, tlen, got = (b"*", 0), 0, (x.rnext, x.pnext)
        if not (x.mapped and y.mapped) and x.flag & F_PROPER:
            reasons.append("proper")
        if got != fields or x.tlen != tlen:
            reasons.append("mate_fields")

    def judge(self, samples: List[Tuple[int, Optional[Record]]], due: int = 0) -> Verdict:
        """Judge each drawn read's primary record: `samples` holds (pool
        read, its record or None when it never came); for a paired pool
        the two mates of a pair follow each other, mate 1 first. Where
        fewer than `due` reads could be drawn, the shortfall counts as
        missing."""
        p = self.pool
        rows = np.asarray([r for r, _ in samples], dtype=np.int64)
        real = np.unique(rows[p.mappable[rows]]) if len(rows) else rows
        opt = dict(zip(real.tolist(), self.optimum(real).tolist()))
        counts: Dict[str, int] = {}
        wrong = replay_bad = gap_max = placed = gaps = field_bad = 0
        for i, (r, rec) in enumerate(samples):
            reasons: List[str] = []
            if rec is None:
                reasons.append("missing")
            else:
                self._seq(rec, r, reasons)
                if rec.mapped and not self._replay(rec, reasons):
                    replay_bad += 1
                if p.mappable[r] and self._placed(rec, r, reasons):
                    gap = opt[r] - (rec.as_ if rec.as_ is not None else 0)
                    gap_max = max(gap_max, abs(gap))
                    placed += 1
                    if gap != 0:
                        gaps += 1
                        reasons.append("score")
                if p.paired:
                    mate_row, y = samples[i ^ 1]
                    if y is None:
                        reasons.append("missing_mate")
                    else:
                        self._mate_fields(rec, y, r % 2 == 0,
                                          bool(p.mappable[r] and p.mappable[mate_row]), reasons)
                elif rec.flag & ~(F_REVERSE | F_UNMAP):
                    reasons.append("flags")
            wrong += bool(reasons)
            field_bad += any(why in FIELD_REASONS for why in reasons)
            for why in set(reasons):
                counts[why] = counts.get(why, 0) + 1
        short = max(due - len(samples), 0)
        if short:
            counts["missing"] = counts.get("missing", 0) + short
        return Verdict(n_reads=len(samples) + short, wrong=wrong + short, replay_errors=replay_bad,
                       placed=placed, score_gaps=gaps, field_errors=field_bad, reasons=counts,
                       score_gap_max=int(gap_max))


def primary_by_read(records: List[Record], paired: bool) -> Dict[int, Record]:
    """The first primary record of each pool read among `records`."""
    out: Dict[int, Record] = {}
    for rec in records:
        if rec.flag & (F_SECONDARY | F_SUPPLEMENTARY):
            continue
        r = read_index(rec.qname)
        if paired:
            r = 2 * r + (1 if rec.flag & F_READ2 else 0)
        out.setdefault(r, rec)
    return out


def draw_samples(kept: Dict[int, bytes], pool_chunks: int, chunk_reads: int, n_reads: int,
                 n: int, paired: bool, rng) -> List[Tuple[int, Optional[Record]]]:
    """Up to n reads (whole pairs for a paired pool), drawn by `rng` from
    the chunks kept from the window (chunk k of the window carried pool
    chunk k % pool_chunks), each with its primary record in that chunk."""
    unit = 2 if paired else 1
    cand = [(k, r) for k in sorted(kept)
            for r in range((k % pool_chunks) * chunk_reads,
                           min((k % pool_chunks + 1) * chunk_reads, n_reads), unit)]
    pick = sorted(rng.choice(len(cand), size=min(len(cand), n // unit), replace=False).tolist())
    by_chunk: Dict[int, list] = {}
    for i in pick:
        by_chunk.setdefault(cand[i][0], []).append(cand[i][1])
    samples: List[Tuple[int, Optional[Record]]] = []
    for k, rows in by_chunk.items():
        want = {read_index(_name(r, paired)) for r in rows}
        lines = [ln for ln in kept[k].split(b"\n")
                 if ln and int(ln[1:ln.index(b"\t")]) in want]
        found = primary_by_read(parse_sam(b"\n".join(lines)), paired)
        for r in rows:
            samples.extend((r + m, found.get(r + m)) for m in range(unit))
    return samples


def _name(row: int, paired: bool) -> bytes:
    return b"p%d" % (row // 2) if paired else b"r%d" % row


def control_sam(judge: Judge, rows: np.ndarray, dtype=np.int8) -> bytes:
    """The control: the reference put in the program's place, computed in
    `dtype`. Each read that was cut from the genome is placed at its
    origin with the CIGAR of its edits and the reference optimum as its
    AS, worked out in `dtype` arithmetic (int8: the nearest type below
    the int16 that the program's scores already fit exactly, so the
    first type that loses them); a random read is left unmapped. Pairs
    get their flags and mate fields by the aligner's SAM rules, as the
    judge states them."""
    p = judge.pool
    rows = np.asarray(sorted(rows), dtype=np.int64)
    real = rows[p.mappable[rows]]
    scores = dict(zip(real.tolist(), judge.optimum(real, dtype).tolist()))
    L = p.fwd.shape[1]
    recs: Dict[int, Record] = {}
    for r in rows.tolist():
        as_read = p.fwd[r] if not p.rc[r] else _revcomp(p.fwd[r])
        name = p.names[r][:-2] if p.paired else p.names[r]
        if not p.mappable[r]:
            recs[r] = Record(name, F_UNMAP, b"*", 0, b"*", b"*", 0, 0,
                             np.frombuffer(b"ACGT", np.uint8)[as_read].tobytes(), None, None)
            continue
        d, at = int(p.deletion[r]), int(p.del_at[r])
        cigar = b"%dM%dD%dM" % (at, d, L - at) if d else b"%dM" % L
        recs[r] = Record(name, F_REVERSE if p.rc[r] else 0, judge.names[p.contig[r]],
                         int(p.start[r]) + 1, cigar, b"*", 0, 0,
                         np.frombuffer(b"ACGT", np.uint8)[p.fwd[r]].tobytes(),
                         int(p.subs[r]) + d, int(scores[r]))
    if p.paired:
        for r in rows[::2].tolist():
            _pair_fields(recs[r], recs[r + 1], judge.max_insert)
    lines = []
    for r in rows.tolist():
        x = recs[r]
        lines.append(b"\t".join([x.qname, b"%d" % x.flag, x.rname, b"%d" % x.pos, b"60", x.cigar,
                                 x.rnext, b"%d" % x.pnext, b"%d" % x.tlen, x.seq, b"*"]
                                + ([b"NM:i:%d" % x.nm, b"AS:i:%d" % x.as_] if x.mapped else [])))
    return b"\n".join(lines) + b"\n"


def _pair_fields(a: Record, b: Record, max_insert: int) -> None:
    """Flags and mate fields of a pair's two records (add_pair's rules)."""
    a.flag |= F_PAIRED | F_READ1
    b.flag |= F_PAIRED | F_READ2
    for x, y in ((a, b), (b, a)):
        if not y.mapped:
            x.flag |= F_MUNMAP
        elif y.flag & F_REVERSE:
            x.flag |= F_MREVERSE
    if a.mapped and b.mapped:
        dist = b.pos - a.pos
        span1, span2 = ref_span(parse_cigar(a.cigar)), ref_span(parse_cigar(b.cigar))
        tlen = dist + span2 if dist > 0 else dist - span1
        same = a.rname == b.rname
        a.rnext, a.pnext, b.rnext, b.pnext = (b"=" if same else b.rname), b.pos, \
            (b"=" if same else a.rname), a.pos
        a.tlen, b.tlen = (tlen, -tlen) if same else (0, 0)
        facing = ((not a.flag & F_REVERSE and b.flag & F_REVERSE and dist >= 0)
                  or (a.flag & F_REVERSE and not b.flag & F_REVERSE and dist <= 0))
        if same and facing and abs(dist) <= max_insert:
            a.flag |= F_PROPER
            b.flag |= F_PROPER
    elif a.mapped or b.mapped:
        m, u = (a, b) if a.mapped else (b, a)
        m.rnext, m.pnext = b"=", m.pos
        u.rname, u.pos, u.rnext, u.pnext = m.rname, m.pos, b"=", m.pos
    else:
        for x in (a, b):
            x.rname, x.pos, x.rnext, x.pnext = b"*", 0, b"*", 0
