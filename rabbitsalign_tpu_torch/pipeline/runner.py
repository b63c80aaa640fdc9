"""Application entry: index build/load, the mapping loop, output.

Plays the role of reference src/main.cpp run_rabbitsalign on one host
with one mapping thread: the native pipeline (pipeline/native_pipeline.py)
runs the C++ engine's phases with the extend batches on the device given
by ``--device``. Options whose code paths are not ported yet are refused
up front (`_reject_unported`) rather than silently running something
else.
"""

from __future__ import annotations

import sys
import time

from ..align.aligner import AlignmentParameters
from ..cli import CommandLineOptions
from ..index.params import DEFAULT, IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.fastq import estimate_read_length
from ..io.sam import sam_header
from ..map.common import MappingParameters
from ..utils.logger import logger


def _reject_unported(opt: CommandLineOptions) -> None:
    unported = [
        (opt.n_threads > 1 and not opt.only_gen_index,
         "-t/--threads > 1 for mapping (the threaded pipeline)"),
        (opt.device_seed, "--device-seed"),
        (opt.shard_index, "--shard-index"),
        (opt.mmap_index, "--mmap-index"),
        (opt.num_nodes > 1, "--num-nodes > 1 (multi-host)"),
        (opt.profile_dir is not None, "--profile"),
    ]
    for given, name in unported:
        if given:
            raise NotImplementedError(f"{name} is not yet ported to rabbitsalign_tpu_torch")


def run_aligner(opt: CommandLineOptions) -> int:
    _reject_unported(opt)
    logger.set_level("debug" if opt.verbose else "info")
    t_start = time.perf_counter()

    if opt.c >= 64 or opt.c <= 0:
        raise ValueError("c must be greater than 0 and less than 64")

    if not opt.r_set and opt.reads_filename1:
        opt.r = estimate_read_length(opt.reads_filename1, opt.reads_filename2,
                                     opt.is_interleaved)
        logger.info(f"Estimated read length: {opt.r} bp")

    index_parameters = IndexParameters.from_read_length(
        opt.r,
        opt.k if opt.k_set else DEFAULT,
        opt.s if opt.s_set else DEFAULT,
        opt.l if opt.l_set else DEFAULT,
        opt.u if opt.u_set else DEFAULT,
        opt.c if opt.c_set else DEFAULT,
        opt.max_seed_len if opt.max_seed_len_set else DEFAULT,
    )
    aln_params = AlignmentParameters(
        match=opt.A, mismatch=opt.B, gap_open=opt.O, gap_extend=opt.E,
        end_bonus=opt.end_bonus,
    )
    map_param = MappingParameters(
        r=opt.r,
        max_secondary=opt.max_secondary,
        dropoff_threshold=opt.dropoff_threshold,
        rescue_level=opt.rescue_level,
        max_tries=opt.max_tries,
        is_sam_out=opt.is_sam_out,
        cigar_eqx=opt.cigar_eqx,
        output_unmapped=opt.output_unmapped,
        details=opt.details,
        pe_ref_async=opt.pe_ref_async,
    )
    map_param.verify()

    t0 = time.perf_counter()
    references = References.from_fasta(opt.ref_filename)
    logger.info(f"Time reading reference: {time.perf_counter() - t0:.2f} s")
    if references.total_length() == 0:
        raise RuntimeError("No reference sequences found")
    logger.info(
        f"Reference size: {references.total_length() / 1e6:.2f} Mbp "
        f"({len(references)} contig{'s' if len(references) != 1 else ''})"
    )

    index = StrobemerIndex(references, index_parameters, opt.bits)
    if opt.use_index:
        sti_path = opt.ref_filename + index_parameters.filename_extension()
        logger.info(f"Reading index from {sti_path}")
        t0 = time.perf_counter()
        index.read(sti_path)
        logger.info(f"Total time reading index: {time.perf_counter() - t0:.2f} s")
    else:
        logger.info("Indexing ...")
        t0 = time.perf_counter()
        index.populate(opt.f, opt.n_threads)
        logger.info(f"Total time indexing: {time.perf_counter() - t0:.2f} s")
        st = index.stats
        logger.debug(f"Total number of randstrobes: {st.tot_strobemer_count}")
        logger.debug(f"Total number of distinct randstrobes: {st.distinct_strobemers}")
        if st.distinct_strobemers:
            frac1 = st.tot_occur_once / st.distinct_strobemers
            logger.debug(f"Fraction of unique randstrobes: {frac1:.4f}")
            logger.debug(f"Highly abundant randstrobes (>100): {st.tot_high_ab}")
            logger.debug(f"Mid abundance randstrobes (2-100): {st.tot_mid_ab}")
        logger.debug(f"Filter cutoff: {index.filter_cutoff}")
        if opt.logfile_name:
            from ..index.diagnostics import print_diagnostics

            print_diagnostics(index, opt.logfile_name, index_parameters.syncmer.k)
        if opt.only_gen_index:
            sti_path = opt.ref_filename + index_parameters.filename_extension()
            logger.info(f"Writing index to {sti_path}")
            index.write(sti_path)
            return 0

    map_param.rescue_cutoff = (
        map_param.rescue_level * index.filter_cutoff
        if map_param.rescue_level < 100
        else 1000
    )
    logger.debug(f"Using rescue cutoff: {map_param.rescue_cutoff}")

    # binary output end-to-end: the engine produces ASCII SAM/PAF bytes
    out = (
        sys.stdout.buffer if opt.write_to_stdout
        else open(opt.output_file_name, "wb")
    )
    try:
        _map_reads(opt, out, references, index, index_parameters, map_param,
                   aln_params)
        out.flush()
    finally:
        if not opt.write_to_stdout:
            out.close()
    logger.info("Done!")
    logger.info(f"Total time mapping: {time.perf_counter() - t_start:.2f} s.")
    return 0


def _make_progress(opt, t_start):
    """Periodic reads/s line on stderr (reference src/main.cpp:146-181);
    active when --no-progress is not given and stderr is a terminal."""
    if not opt.show_progress or not sys.stderr.isatty():
        return None
    state = {"last": 0.0}

    def progress(n_reads: int) -> None:
        now = time.perf_counter()
        if now - state["last"] >= 1.0:
            state["last"] = now
            rate = n_reads / max(now - t_start, 1e-9)
            print(f" Processed {n_reads} reads in {now - t_start:.1f} s "
                  f"({rate:.0f} reads/s)", end="\r", file=sys.stderr)

    return progress


def _map_reads(opt, out, references, index, index_parameters, map_param,
               aln_params) -> None:
    from .native_pipeline import NativePipeline

    if map_param.is_sam_out:
        out.write(
            sam_header(references, opt.read_group_id, opt.read_group_fields,
                       " ".join(sys.argv)).encode()
        )
    pipeline = NativePipeline(
        index, index_parameters, references, aln_params, map_param,
        opt.read_group_id, use_device=opt.use_tpu, batch_size=opt.tpu_batch,
        device=opt.device,
    )
    t0 = time.perf_counter()
    # no retry-from-scratch fallback: map_file writes output
    # incrementally, so re-running after a mid-run failure would append
    # duplicate records — let the error propagate
    n_reads = pipeline.map_file(
        opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
        opt.chunk_size, out.write, progress=_make_progress(opt, t0),
    )
    elapsed = time.perf_counter() - t0
    c = pipeline.counters()
    logger.info(f"Mapped {n_reads} reads in {elapsed:.2f} s "
                f"({n_reads / max(elapsed, 1e-9):.0f} reads/s)")
    logger.info(f"Total mapping sites tried: {c['tot_all_tried']}")
    logger.info(f"Total calls to ssw: {c['aligner_calls']}")
    logger.info(f"Inconsistent NAM ends: {c['inconsistent_nams']}")
    logger.info(f"Tried NAM rescue: {c['nam_rescue']}")
    logger.info(f"Mates rescued by alignment: {c['tot_rescued']}")
    tm = pipeline.engine.timers()
    logger.info(
        "Phase times: seeding+NAMs %.2f s, phase A total %.2f s, "
        "host alignment %.2f s, pairing+output %.2f s"
        % (tm["seed_nam_s"], tm["phase_a_s"], tm["host_align_s"],
           tm["phase_b_s"])
    )
