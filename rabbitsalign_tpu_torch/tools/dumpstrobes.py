"""dumpstrobes: emit syncmers or randstrobes of a reference as BED.

Standalone debug tool mirroring the reference's dumpstrobes binary
(reference src/dumpstrobes.cpp): one BED record per seed with the
spanned reference interval.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..index.params import DEFAULT, IndexParameters
from ..io.fasta import References
from ..seed.randstrobes import randstrobes_reference
from ..seed.syncmers import syncmers


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="dumpstrobes-tpu-torch")
    p.add_argument("--syncmers", action="store_true",
                   help="dump syncmers instead of randstrobes")
    p.add_argument("-r", type=int, default=150, help="read length profile [150]")
    p.add_argument("-k", type=int, default=None)
    p.add_argument("-s", type=int, default=None)
    p.add_argument("ref", help="reference FASTA")
    args = p.parse_args(argv)

    params = IndexParameters.from_read_length(
        args.r,
        args.k if args.k is not None else DEFAULT,
        args.s if args.s is not None else DEFAULT,
    )
    refs = References.from_fasta(args.ref)
    out = sys.stdout
    k = params.syncmer.k
    for name, seq in zip(refs.names, refs.sequences):
        if args.syncmers:
            pos, _ = syncmers(seq, k, params.syncmer.s, params.syncmer.t_syncmer)
            for x in pos:
                out.write(f"{name}\t{x}\t{x + k}\n")
        else:
            _, p1, p2 = randstrobes_reference(seq, params)
            for a, b in zip(p1, p2):
                out.write(f"{name}\t{a}\t{b + k}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
