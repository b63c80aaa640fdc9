"""Synthetic extend batches shared by the port's tests and chip_smoke.py:
numpy only (no jax, no torch), so they also run where JAX is absent."""

import numpy as np

KINDS = ("planted", "indel", "n-run", "tandem", "junk", "empty", "overflow")


def q2_batch(pairs, Q, seed=0):
    """(q2 upload (rows, B) u8, genome codes): each pair's target is laid
    into a random genome and its query packed 2-bit with the N mask, as
    engine.cpp chunk_fill_batch_q2 does. Pairs are (query, target) code
    arrays (0..4)."""
    rng = np.random.RandomState(seed)
    Qp, Qm = (Q + 3) // 4, (Q + 7) // 8
    B = len(pairs)
    buf = np.zeros((Qp + Qm + 8, B), dtype=np.uint8)
    parts = [rng.randint(0, 4, 64).astype(np.uint8)]
    off = 64
    for b, (q, t) in enumerate(pairs):
        q = np.asarray(q, dtype=np.uint8)
        t = np.asarray(t, dtype=np.uint8)
        r = np.arange(q.shape[0])
        np.bitwise_or.at(buf[:, b], r >> 2, ((q & 3) << ((r & 3) << 1)).astype(np.uint8))
        np.bitwise_or.at(buf[:, b], Qp + (r >> 3),
                         np.where(q >= 4, 1 << (r & 7), 0).astype(np.uint8))
        tail = buf[Qp + Qm:, b]
        tail[0:2] = (q.shape[0] & 0xFF, q.shape[0] >> 8)
        tail[2:4] = (t.shape[0] & 0xFF, t.shape[0] >> 8)
        tail[4:8] = [(off >> s) & 0xFF for s in (0, 8, 16, 24)]
        parts += [t, rng.randint(0, 4, 16).astype(np.uint8)]
        off += t.shape[0] + 16
    return buf, np.concatenate(parts)


def mixed_pairs(Q, T, B, seed=0):
    """B (query, target) code pairs cycling through KINDS, sized to the
    (Q, T) bucket: a planted query with SNPs, one with indels, one with an
    N run, tandem repeats (dense score ties), unrelated junk with N codes,
    an empty query, and a query with a mismatch every sixth base whose
    alignment has more than 32 cigar runs."""
    rng = np.random.RandomState(seed)
    pairs = []
    for b in range(B):
        kind = KINDS[b % len(KINDS)]
        m = int(rng.randint(max(1, Q // 2), Q + 1))
        n = int(rng.randint(min(m, T), T + 1))
        t = rng.randint(0, 4, n).astype(np.uint8)
        if kind in ("planted", "indel", "n-run", "overflow"):
            st = int(rng.randint(0, n - min(m, n) + 1))
            q = t[st:st + m].copy()
            if kind == "planted":
                q[rng.randint(0, q.shape[0], 3)] = rng.randint(0, 4, 3)
            elif kind == "indel":
                cut = int(rng.randint(1, max(2, q.shape[0] - 1)))
                if rng.randint(2):
                    q = np.concatenate([q[:cut], q[cut + int(rng.randint(1, 6)):]])
                else:
                    q = np.concatenate([q[:cut], rng.randint(0, 4, int(rng.randint(1, 5))),
                                        q[cut:]])[:Q].astype(np.uint8)
            elif kind == "n-run":
                p = int(rng.randint(0, max(1, q.shape[0] - 8)))
                q[p:p + int(rng.randint(2, 8))] = 4
            else:
                q[3::6] = (q[3::6] + 1) % 4
        elif kind == "tandem":
            u = int(rng.randint(3, 20))
            q = (np.arange(m) % u % 4).astype(np.uint8)
            t = (np.arange(n) % u % 4).astype(np.uint8)
        elif kind == "junk":
            q = rng.randint(0, 5, m).astype(np.uint8)
            t = rng.randint(0, 5, n).astype(np.uint8)
        else:  # empty
            q = np.zeros(0, np.uint8)
        pairs.append((q[:Q], t[:T]))
    return pairs
