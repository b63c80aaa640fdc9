"""Index diagnostics CSV (--index-statistics), mirroring
StrobemerIndex::print_diagnostics (reference src/index.cpp:311-390)
BUG-FOR-BUG so the CSV is byte-comparable with the reference binary's:

* the per-entry count is ``get_count(it)`` — the SUFFIX of the entry's
  equal-hash run (a run of 3 contributes counts 3, 2, 1 — reference
  src/index.hpp:115-147), not the total run length;
* ``e_count`` uses the reference's INTEGER division
  (``randstrobe_hash_t / int``) before being printed as a double;
* the median loop never assigns its result, so the summary line always
  prints median 0;
* doubles print like a default-precision std::ostream (%.6g).
"""

from __future__ import annotations

import numpy as np

from .strobemer_index import StrobemerIndex


def _cpp_double(x: float) -> str:
    """Default std::ostream double formatting (6 significant digits)."""
    return f"{x:.6g}"


def print_diagnostics(index: StrobemerIndex, logfile_name: str, k: int) -> None:
    max_size = 100000
    seed_lengths = (index.packed & 0xFF).astype(np.int64) + k
    n = index.hashes.shape[0]
    # suffix count within the equal-hash run (hashes are sorted, so the
    # run offset is position - first occurrence)
    _, inverse, counts = np.unique(index.hashes, return_inverse=True,
                                   return_counts=True)
    first = np.searchsorted(index.hashes, index.hashes, side="left")
    per_entry_count = counts[inverse] - (np.arange(n) - first)

    in_range = seed_lengths < max_size
    sl = seed_lengths[in_range]
    pc = per_entry_count[in_range]

    log_count = np.bincount(sl, minlength=max_size)
    log_count_squared = np.bincount(
        sl, weights=pc.astype(np.float64), minlength=max_size
    ).astype(np.int64)
    tot_seed_count = int(sl.shape[0])
    tot_seed_count_sq = int(pc.sum())

    lim = pc <= 1000
    log_count_1000 = np.bincount(sl[lim], minlength=max_size)  # noqa: F841
    tot_seed_count_1000 = int(np.count_nonzero(lim))

    with open(logfile_name, "w") as f:
        for i in np.flatnonzero(log_count > 0):
            # reference: uint64 / int -> floored BEFORE the double print
            e_count = int(log_count_squared[i]) // int(log_count[i])
            f.write(f"{i},{log_count[i]},{_cpp_double(float(e_count))}\n")
        median = 0  # the reference's median loop never assigns its result
        f.write("E_size for total seeding wih max seed size m below "
                "(m, tot_seeds, E_hits)\n")
        e_hits = tot_seed_count_sq / tot_seed_count if tot_seed_count else 0.0
        fraction_masked = (
            1.0 - tot_seed_count_1000 / tot_seed_count if tot_seed_count else 0.0
        )
        f.write(f"{median},{tot_seed_count},{_cpp_double(e_hits)},"
                f"{_cpp_double(100 * fraction_masked)}\n")
