"""Command-line interface: the flags of rabbitsalign_tpu's CLI (which
follows the reference aligner, reference src/cmdline.{hpp,cpp})
plus ``--device``. Flags whose code paths are not ported yet are
accepted by the parser and refused by the runner with a clear error."""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import List, Optional

from . import version_string


@dataclass
class CommandLineOptions:
    """reference src/cmdline.hpp:8-64"""

    # one mapping thread: the threaded pipeline is not ported yet
    n_threads: int = 1
    chunk_size: int = 10000
    output_file_name: str = ""
    write_to_stdout: bool = True
    verbose: bool = False
    details: bool = False
    show_progress: bool = True
    cigar_eqx: bool = False
    read_group_id: str = ""
    read_group_fields: List[str] = field(default_factory=list)
    logfile_name: str = ""
    only_gen_index: bool = False
    use_index: bool = False
    mmap_index: bool = False
    pin_workers: bool = False
    pod_index_peers: str = ""
    is_sam_out: bool = True
    output_unmapped: bool = True
    max_secondary: int = 0
    r: int = 150
    bits: int = -1
    r_set: bool = False
    max_seed_len_set: bool = False
    k_set: bool = False
    s_set: bool = False
    l_set: bool = False
    u_set: bool = False
    c_set: bool = False
    max_seed_len: int = 0
    k: int = 20
    l: int = 0
    u: int = 7
    s: int = 16
    c: int = 8
    A: int = 2
    B: int = 8
    O: int = 12
    E: int = 1
    end_bonus: int = 10
    f: float = 0.0002
    dropoff_threshold: float = 0.5
    max_tries: int = 20
    rescue_level: int = 2
    ref_filename: str = ""
    reads_filename1: str = ""
    reads_filename2: str = ""
    is_SE: bool = True
    is_interleaved: bool = False
    # device extensions (declared here so programmatic callers get the
    # same defaults the CLI sets)
    tpu_batch: int = 1024
    use_tpu: bool = True
    deterministic: bool = False
    pe_ref_async: bool = False
    device_seed: bool = False
    shard_index: bool = False
    profile_dir: Optional[str] = None
    num_nodes: int = 1
    node_id: int = 0
    coordinator: Optional[str] = None
    no_sidecar: bool = False
    device: str = "cuda"


def parse_command_line_arguments(argv: Optional[List[str]] = None) -> CommandLineOptions:
    p = argparse.ArgumentParser(
        prog="rabbitsalign-tpu-torch",
        description=f"rabbitsalign-tpu-torch {version_string()} — short-read "
                    "aligner with its extend phase on a CUDA GPU",
    )
    p.add_argument("--version", action="version", version=version_string())
    p.add_argument("-t", "--threads", type=int, default=None, metavar="INT",
                   help="Number of mapping threads [1]; more than one is "
                        "not yet ported")
    p.add_argument("--pin-workers", action="store_true",
                   help="Pin each mapping worker thread to one CPU "
                        "(round-robin over the allowed set) — the "
                        "reference's consumer-thread affinity; useful on "
                        "many-core NUMA hosts")
    p.add_argument("--chunk-size", type=int, default=None, metavar="INT",
                   help=argparse.SUPPRESS)
    # Input/output
    p.add_argument("-o", dest="o", metavar="PATH", help="redirect output to file [stdout]")
    p.add_argument("-v", dest="v", action="store_true", help="Verbose output")
    p.add_argument("--no-progress", action="store_true",
                   help="Disable progress report")
    p.add_argument("--eqx", action="store_true",
                   help="Emit =/X instead of M CIGAR operations")
    p.add_argument("-x", dest="x", action="store_true",
                   help="Only map reads, no base level alignment (produces PAF file)")
    p.add_argument("-U", dest="U", action="store_true",
                   help="Suppress output of unmapped reads")
    p.add_argument("--interleaved", action="store_true", help="Interleaved input")
    p.add_argument("--rg-id", metavar="ID", help="Read group ID")
    p.add_argument("--rg", action="append", default=[], metavar="TAG:VALUE",
                   help="Add read group metadata to SAM header")
    p.add_argument("--details", action="store_true",
                   help="Add debugging details to SAM records")
    p.add_argument("-N", dest="N", type=int, default=None, metavar="INT",
                   help="Retain at most INT secondary alignments [0]")
    p.add_argument("--index-statistics", metavar="PATH",
                   help="Print statistics of indexing to PATH")
    p.add_argument("-i", "--create-index", action="store_true",
                   help="Only generate the strobemer index and write it to disk")
    p.add_argument("--use-index", action="store_true",
                   help="Use a pre-generated index")
    p.add_argument("--mmap-index", action="store_true",
                   help="With --use-index: memory-map the index via a "
                        "columnar sidecar (built on first use) instead of "
                        "loading it up front — O(1) open, pages stream in "
                        "while mapping runs (not yet ported)")
    p.add_argument("--no-sidecar", action="store_true",
                   help="With -i/--create-index: skip writing the columnar "
                        "mmap sidecar (no sidecar is written until "
                        "--mmap-index is ported)")
    # Seeding
    p.add_argument("-r", dest="r", type=int, default=None, metavar="INT",
                   help="Mean read length; index parameters are chosen from it")
    p.add_argument("-m", dest="m", type=int, default=None, metavar="INT",
                   help="Maximum seed length")
    p.add_argument("-k", dest="k", type=int, default=None, metavar="INT",
                   help="Strobe length [20]")
    p.add_argument("-l", dest="l", type=int, default=None, metavar="INT",
                   help="Lower syncmer offset from k/(k-s+1)")
    p.add_argument("-u", dest="u", type=int, default=None, metavar="INT",
                   help="Upper syncmer offset from k/(k-s+1)")
    p.add_argument("-s", dest="s", type=int, default=None, metavar="INT",
                   help="Submer size for creating syncmers [k-4]")
    p.add_argument("-c", dest="c", type=int, default=None, metavar="INT",
                   help="Bitcount length between 2 and 63 [8]")
    p.add_argument("-b", dest="bits", type=int, default=None, metavar="INT",
                   help=argparse.SUPPRESS)
    # Alignment
    p.add_argument("-A", dest="A", type=int, default=None, help="Matching score [2]")
    p.add_argument("-B", dest="B", type=int, default=None, help="Mismatch penalty [8]")
    p.add_argument("-O", dest="O", type=int, default=None, help="Gap open penalty [12]")
    p.add_argument("-E", dest="E", type=int, default=None, help="Gap extension penalty [1]")
    p.add_argument("-L", dest="L", type=int, default=None, help="Soft clipping penalty [10]")
    # Search
    p.add_argument("-f", dest="f", type=float, default=None,
                   help="Top fraction of repetitive strobemers to filter out [0.0002]")
    p.add_argument("-S", dest="S", type=float, default=None,
                   help="Try candidate sites with score at least S of maximum [0.5]")
    p.add_argument("-M", dest="M", type=int, default=None,
                   help="Maximum number of mapping sites to try [20]")
    p.add_argument("-R", dest="R", type=int, default=None,
                   help="Rescue level [2]")
    # device extensions
    p.add_argument("--device-seed", action="store_true",
                   help="Run seeding + index lookup on the accelerator "
                        "(not yet ported)")
    p.add_argument("--shard-index", action="store_true",
                   help="Serve every index lookup from a hash-sharded "
                        "index spread across the device mesh (whole-"
                        "genome scale-out) instead of a per-host replica "
                        "(not yet ported)")
    p.add_argument("--pe-ref-async", action="store_true",
                   help="Replicate the reference binary's async PE "
                        "insert-size semantics exactly (per-chunk "
                        "estimator, gather-time rescue windows) instead "
                        "of the monolithic semantics")
    p.add_argument("--deterministic", action="store_true",
                   help="Round-robin chunk handout to worker threads so "
                        "N-thread PE output is reproducible run to run")
    p.add_argument("--tpu-batch", type=int, default=None, metavar="INT",
                   help="Device extension batch size cap [1024]")
    p.add_argument("--no-tpu", action="store_true",
                   help="Disable the device extend path (host alignment only)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device of the extend kernels [cuda]; cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Write a profiler trace of the mapping run to DIR "
                        "(not yet ported)")
    # multi-host pod scale-out (requires -o on a shared fs; not yet ported)
    p.add_argument("--num-nodes", type=int, default=1, metavar="INT",
                   help="Number of hosts in the pod [1]; more than one is "
                        "not yet ported")
    p.add_argument("--node-id", type=int, default=0, metavar="INT",
                   help="This host's index in the pod [0]")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="Coordinator address (node 0)")
    p.add_argument("--pod-index-peers", metavar="HOST:PORT,...", default="",
                   help="Split the index across the pod hosts (one lookup "
                        "endpoint per node, comma-separated, node-id "
                        "order); each host keeps only its hash-range "
                        "slice and serves it to the others. With "
                        "--mmap-index a host never materializes the full "
                        "index in RAM")
    p.add_argument("ref_filename", metavar="reference",
                   help="Reference in FASTA format")
    p.add_argument("reads1", nargs="?", default="", help="Reads 1 (FASTA/FASTQ, may be .gz)")
    p.add_argument("reads2", nargs="?", default="", help="Reads 2 (FASTA/FASTQ, may be .gz)")

    args = p.parse_args(argv)
    opt = CommandLineOptions()
    if args.threads is not None:
        opt.n_threads = args.threads
    if args.chunk_size is not None:
        opt.chunk_size = args.chunk_size
    if args.o:
        opt.output_file_name = args.o
        opt.write_to_stdout = False
    opt.verbose = args.v
    opt.details = args.details
    if args.no_progress:
        opt.show_progress = False
    opt.cigar_eqx = args.eqx
    if args.x:
        opt.is_sam_out = False
    if args.U:
        opt.output_unmapped = False
    if args.rg_id:
        opt.read_group_id = args.rg_id
    opt.read_group_fields = args.rg
    if args.N is not None:
        opt.max_secondary = args.N
    if args.index_statistics:
        opt.logfile_name = args.index_statistics
    opt.only_gen_index = args.create_index
    opt.use_index = args.use_index
    opt.mmap_index = args.mmap_index
    opt.no_sidecar = args.no_sidecar
    opt.pin_workers = args.pin_workers
    opt.pod_index_peers = args.pod_index_peers

    for name in ("r", "k", "l", "u", "s", "c"):
        val = getattr(args, name)
        if val is not None:
            setattr(opt, name, val)
            setattr(opt, f"{name}_set", True)
    if args.m is not None:
        opt.max_seed_len = args.m
        opt.max_seed_len_set = True
    if args.bits is not None:
        opt.bits = args.bits
    for name in ("A", "B", "O", "E"):
        val = getattr(args, name)
        if val is not None:
            setattr(opt, name, val)
    if args.L is not None:
        opt.end_bonus = args.L
    if args.f is not None:
        opt.f = args.f
    if args.S is not None:
        opt.dropoff_threshold = args.S
    if args.M is not None:
        opt.max_tries = args.M
    if args.R is not None:
        opt.rescue_level = args.R

    opt.ref_filename = args.ref_filename
    opt.reads_filename1 = args.reads1
    opt.is_interleaved = args.interleaved
    if args.reads2:
        if args.interleaved:
            # reference src/main.cpp:138 rejects the combination; two
            # files + the flag would otherwise silently pair positionally
            p.error("Cannot specify both --interleaved and two read files")
        opt.reads_filename2 = args.reads2
        opt.is_SE = False
    elif args.interleaved:
        opt.is_SE = False

    opt.tpu_batch = args.tpu_batch if args.tpu_batch is not None else 1024
    if opt.tpu_batch < 8:
        p.error("--tpu-batch must be at least 8")
    if opt.E > opt.O:
        # gap-open cheaper than extension flips SSW's in-column gap
        # semantics (probed: real ssw.c diverges from its own documented
        # recurrence there); every aligner layer here assumes O >= E
        p.error("gap extension penalty (-E) must not exceed gap open (-O)")
    opt.deterministic = args.deterministic
    opt.pe_ref_async = args.pe_ref_async
    opt.device_seed = args.device_seed
    opt.shard_index = args.shard_index
    opt.use_tpu = not args.no_tpu
    opt.device = args.device
    opt.profile_dir = args.profile
    opt.num_nodes = args.num_nodes
    opt.node_id = args.node_id
    opt.coordinator = args.coordinator
    if opt.num_nodes > 1 and not opt.output_file_name:
        p.error("multi-host runs need -o PATH on a shared filesystem")
    if opt.mmap_index and not opt.use_index:
        # the sidecar only exists on the --use-index load path; building
        # the index in RAM and silently ignoring the flag is exactly the
        # GRCh38-scale startup cost the user asked to avoid
        p.error("--mmap-index requires --use-index (the sidecar is keyed "
                "on an existing .sti)")
    if opt.pod_index_peers and opt.num_nodes <= 1:
        # the pod-sharded index only exists inside the multihost branch;
        # silently running single-node with the full index in RAM would
        # defeat the flag's stated point
        p.error("--pod-index-peers requires --num-nodes > 1")

    if opt.use_index and opt.only_gen_index:
        p.error("Options -i and --use-index cannot be used at the same time")
    if not opt.reads_filename1 and not opt.only_gen_index:
        p.error("At least one file with reads must be specified.")
    if opt.only_gen_index and not (opt.r_set or opt.reads_filename1):
        p.error(
            "The target read length needs to be known when generating an index.\n"
            "Use -r to set it explicitly or provide at least one read file."
        )
    return opt


def main(argv: Optional[List[str]] = None) -> int:
    from .pipeline.runner import run_aligner

    try:
        return run_aligner(parse_command_line_arguments(argv))
    except (ValueError, RuntimeError, OSError) as e:
        print(f"rabbitsalign-tpu-torch: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
