"""Reference-ordered sorting.

The reference sorts NAMs, hits and alignment candidates with libstdc++'s
(unstable) std::sort; with equal keys the resulting order is an introsort
artifact that the downstream tie-breaking then consumes, i.e. it is
observable output. `introsort` reorders a list with exactly that
permutation through the engine's index-array std::sort
(native.sort_perm), which performs the same comparison and swap sequence.
Only under RABBITSALIGN_TPU_NO_NATIVE, where `sort_perm` returns None,
does it take a stable sort instead, as the JAX package does without its
library; the order then differs only among equal keys. Without the
variable an engine that does not load raises.
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
    if perm is None:
        perm = sorted(range(len(lst)),
                      key=(lambda i: -keys[i]) if descending else (lambda i: keys[i]))
    lst[:] = [lst[i] for i in perm]
