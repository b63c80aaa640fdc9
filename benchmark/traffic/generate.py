"""The one generator of the benchmark: a genome and a read pool from a
seed, shaped by a configuration file (contig names and lengths) and a
traffic mix file (read model parameters).

The read model is bench.py's (np_genome :56, simulate_se :66,
simulate_pe :94, write_fastq :128) with its constants lifted into the
mix files (benchmark/mixes/*.json) and its per-read Python loops
replaced by NumPy, so that a pool of 240 000 reads costs a fraction of
a second of set-up. Two things differ on purpose: a substitution always
changes the base (bench.py's may draw the same one), and the truth of
every read (contig, start, strand, edits) is kept, since the plain
reference judges the output against it.

Every seed gets the same amount of work: the kinds of reads (random,
deleted, reverse-complemented) are assigned by index, as bench.py does
with ``i % 50``; only positions and edits come from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# complement of the codes 0..3 (A C G T)
COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)


def streams(seed: int):
    """Independent generators for the genome and the pool, from any
    whole-number seed (more than 32 bits allowed; a negative one is
    taken modulo 2**64)."""
    genome_ss, pool_ss = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(2)
    return np.random.default_rng(genome_ss), np.random.default_rng(pool_ss)


def make_genome(contigs, rng) -> List[np.ndarray]:
    """I.i.d. uniform bases as codes 0..3, one array a contig (bench.py's
    np_genome, with a seed of any size)."""
    return [rng.integers(0, 4, int(length), dtype=np.uint8) for _, length in contigs]


@dataclass
class Pool:
    """The read pool and its truth. `fwd` holds each read as it lies on
    the forward strand (after its edits); the FASTQ gives the reverse
    complement where `rc` is set. A pair's mates are rows 2i and 2i+1."""

    paired: bool
    names: List[bytes]  # FASTQ names, without '@'
    fwd: np.ndarray  # (N, L) uint8 codes, forward strand
    rc: np.ndarray  # (N,) bool: the read was sequenced from the reverse strand
    contig: np.ndarray  # (N,) int32 contig index
    start: np.ndarray  # (N,) int64 0-based leftmost genome base of the read
    deletion: np.ndarray  # (N,) int32 deletion length (0: none)
    del_at: np.ndarray  # (N,) int32 read offset of the deletion
    subs: np.ndarray  # (N,) int32 substitutions
    mappable: np.ndarray  # (N,) bool: False for random reads
    chunk_reads: int  # reads in one reader chunk (a pair counts 2)

    def __len__(self) -> int:
        return len(self.names)


def _substitute(fwd: np.ndarray, mask: np.ndarray, rng) -> None:
    """Change the bases under `mask` to one of the three others."""
    shift = rng.integers(1, 4, size=int(mask.sum()), dtype=np.uint8)
    fwd[mask] = (fwd[mask] + shift) % 4


def _sub_mask(n: int, length: int, mix: dict, rng) -> np.ndarray:
    """(n, length) bool: which bases get a substitution. Either a fixed
    count a read (`subs`), a count drawn uniformly from a range a read
    (`subs_range`, inclusive), or a rate a base (`sub_rate`)."""
    if "sub_rate" in mix:
        return rng.random((n, length)) < float(mix["sub_rate"])
    if "subs_range" in mix:
        lo, hi = mix["subs_range"]
        counts = rng.integers(lo, hi + 1, size=n)
    else:
        counts = np.full(n, int(mix.get("subs", 0)))
    mask = np.zeros((n, length), dtype=bool)
    kmax = int(counts.max(initial=0))
    if kmax == 0:
        return mask
    # distinct positions a read: redraw a position that repeats an earlier one
    pos = rng.integers(0, length, (n, kmax))
    for j in range(1, kmax):
        while True:
            clash = (pos[:, j:j + 1] == pos[:, :j]).any(axis=1)
            if not clash.any():
                break
            pos[clash, j] = rng.integers(0, length, int(clash.sum()))
    used = np.arange(kmax)[None, :] < counts[:, None]
    rows = np.broadcast_to(np.arange(n)[:, None], pos.shape)
    mask[rows[used], pos[used]] = True
    return mask


def _every(n: int, period: int, phase: int) -> np.ndarray:
    """Rows i with i % period == phase % period (period 0: none, 1: all)."""
    if not period:
        return np.zeros(n, dtype=bool)
    return (np.arange(n) % period) == (phase % period)


def _sample_reads(genome, contigs_len, n, length, extra, rng):
    """(contig, start) for n reads each spanning length + extra bases,
    contigs chosen by length."""
    lens = np.asarray(contigs_len, dtype=np.int64)
    room = np.maximum(lens - length - extra - 1, 0)
    if not room.any():
        raise ValueError("no contig is long enough for the reads")
    contig = rng.choice(len(lens), size=n, p=room / room.sum()).astype(np.int32)
    start = (rng.random(n) * room[contig]).astype(np.int64)
    return contig, start


def _cut(genome, contig, start, length, deletion, del_at):
    """(n, length) forward-strand codes of each read, with the deletion
    of `deletion[i]` bases at read offset `del_at[i]`."""
    n = len(start)
    off = np.arange(length, dtype=np.int64)[None, :]
    off = off + np.where(off >= del_at[:, None], deletion[:, None], 0)
    out = np.empty((n, length), dtype=np.uint8)
    for c in np.unique(contig):
        rows = np.flatnonzero(contig == c)
        out[rows] = genome[c][start[rows, None] + off[rows]]
    return out


def make_pool(genome, contigs, mix: dict, rng) -> Pool:
    """The cell's read pool: `mix["reads"]` reads of `mix["read_len"]`
    bases, single-end or interleaved pairs (`mix["paired"]`)."""
    length = int(mix["read_len"])
    n = int(mix["reads"])
    lens = [int(l) for _, l in contigs]
    paired = bool(mix["paired"])
    dmin, dmax = mix.get("deletion_len", [1, 5])
    omin, omax = mix.get("deletion_at", [40, 100])
    if paired:
        n_pairs = n // 2
        lo, hi = mix["insert_clip"]
        insert = np.clip(rng.normal(mix["insert_mean"], mix["insert_sd"], n_pairs),
                         lo, hi).astype(np.int64)
        contig_p, st = _sample_reads(genome, lens, n_pairs, 0, hi, rng)
        contig = np.repeat(contig_p, 2)
        start = np.empty(n, dtype=np.int64)
        start[0::2] = st
        start[1::2] = st + insert - length
        # mate 1 forward, mate 2 reverse (bench.py's simulate_pe)
        rc = np.tile(np.array([False, True]), n_pairs)
        pair_i = np.arange(n_pairs)
        deletion = np.zeros(n, dtype=np.int32)
        with_del = _every(n_pairs, int(mix.get("deletion_every", 0)), 3)
        deletion[0::2][with_del] = rng.integers(dmin, dmax + 1, int(with_del.sum()))
        mappable = np.ones(n, dtype=bool)
        mappable[1::2] = ~_every(n_pairs, int(mix.get("random_mate_every", 0)), 1)
        names = [f"p{i}/{m}".encode() for i in pair_i for m in (1, 2)]
        chunk_reads = 2 * int(mix["chunk_size"])
    else:
        contig, start = _sample_reads(genome, lens, n, length, dmax, rng)
        idx = np.arange(n)
        rc = _every(n, int(mix.get("rc_every", 0)), 2)
        deletion = np.zeros(n, dtype=np.int32)
        with_del = _every(n, int(mix.get("deletion_every", 0)), 1)
        mappable = ~_every(n, int(mix.get("random_every", 0)), 0)
        with_del &= mappable
        deletion[with_del] = rng.integers(dmin, dmax + 1, int(with_del.sum()))
        names = [f"r{i}".encode() for i in idx]
        chunk_reads = int(mix["chunk_size"])
    del_at = np.where(deletion > 0, rng.integers(omin, omax + 1, n), 0).astype(np.int32)
    fwd = _cut(genome, contig, start, length, deletion, del_at)
    sub = _sub_mask(n, length, mix, rng) & mappable[:, None]
    _substitute(fwd, sub, rng)
    random_rows = ~mappable
    fwd[random_rows] = rng.integers(0, 4, (int(random_rows.sum()), length), dtype=np.uint8)
    deletion[random_rows] = 0
    return Pool(paired=paired, names=names, fwd=fwd, rc=rc, contig=contig.astype(np.int32),
                start=start, deletion=deletion, del_at=del_at,
                subs=sub.sum(axis=1).astype(np.int32), mappable=mappable,
                chunk_reads=chunk_reads)


def sequenced(pool: Pool) -> np.ndarray:
    """(N, L) codes as sequenced: the reverse complement where rc."""
    seqs = pool.fwd.copy()
    seqs[pool.rc] = COMPLEMENT[pool.fwd[pool.rc][:, ::-1]]
    return seqs


def fastq_chunks(pool: Pool) -> List[bytes]:
    """The pool as FASTQ (bench.py's write_fastq: constant quality 'I'),
    one bytes object a reader chunk: `chunk_reads` records each, so that
    the reader's chunk boundaries fall where the feeder's do."""
    seqs = ACGT[sequenced(pool)]
    length = seqs.shape[1]
    qual = b"I" * length
    lines = [b"@%s\n%s\n+\n%s\n" % (name, row.tobytes(), qual)
             for name, row in zip(pool.names, seqs)]
    step = pool.chunk_reads
    return [b"".join(lines[i:i + step]) for i in range(0, len(lines), step)]
