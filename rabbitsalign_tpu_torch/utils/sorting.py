"""Reference-ordered sorting.

The reference sorts NAMs, hits and alignment candidates with libstdc++'s
(unstable) std::sort; with equal keys the resulting order is an introsort
artifact that the downstream tie-breaking then consumes, i.e. it is
observable output. `introsort` reorders a list with exactly that
permutation through the engine's index-array std::sort
(native.sort_perm), which performs the same comparison and swap sequence.
There is no fallback: without the engine library it raises, since a
stable sort would change the tie order without a word.
"""

from __future__ import annotations

import numpy as np


def introsort(lst: list, keys, descending: bool) -> None:
    """Reorder `lst` in place by `keys` (uint64 ascending or float64
    descending) in std::sort's order."""
    if len(lst) < 2:
        return
    from ..native import sort_perm

    # a key that does not fit (a packed key past uint64) raises here
    perm = sort_perm(np.asarray(keys, dtype=np.float64 if descending else np.uint64), descending)
    lst[:] = [lst[i] for i in perm]
