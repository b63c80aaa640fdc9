"""Application entry: index build/load, the mapping loop, output.

Plays the role of reference src/main.cpp run_rabbitsalign on one host:
the native pipeline (pipeline/native_pipeline.py) runs the C++ engine's
phases with the extend batches on the devices of ``--device`` (for
cuda every card the process sees, in turn), on one mapping thread
(``-t 1``) or on ``-t`` workers (default 3), each chunk's reads seeded
and looked up on the first card (``--device-seed`` names that default),
or with ``--shard-index`` phase A's index lookups served from the index
cut into hash ranges, one a card. The device prewarm (kernel build, every
card's CUDA context, int16 probe) runs while the reference and index
load. ``--mmap-index`` opens the index
through its columnar sidecar, which ``-i`` writes beside the ``.sti``;
``--profile`` wraps the mapping run in one torch.profiler trace.

With ``--num-nodes N > 1`` the process is one host of a pod
(parallel/multihost.py, `_map_pod`): the hosts join a torch.distributed
gloo group, each maps the chunks with index % N == its node id on one
mapping thread and writes its own output shard beside ``-o``, and node 0
merges the shards after a barrier; ``--pod-index-peers`` splits the
index over the hosts.

Under ``RABBITSALIGN_TPU_NO_NATIVE`` the engine is off, and the run maps
with the Python mapper instead (`_map_reads_python`, the JAX runner's
branch for a host without its library): pipeline/batched.py's phase A and
phase B on the calling thread, with the gapped extensions of each chunk
on the device (ops/batch_extend.py:BatchAligner) or, under ``--no-tpu``,
on the host. ``-t``, ``--device-seed`` and ``--shard-index`` do not apply
there, and a pod run refuses it. A failed engine build without the
variable raises; the run never switches to this path by itself.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time

from ..align.aligner import AlignmentParameters
from ..cli import CommandLineOptions
from ..index.params import DEFAULT, IndexParameters
from ..index.strobemer_index import StrobemerIndex
from ..io.fasta import References
from ..io.fastq import estimate_read_length
from ..io.sam import sam_header
from ..map.common import MappingParameters
from ..native import NO_NATIVE_ENV, native_disabled
from ..utils.logger import logger


def run_aligner(opt: CommandLineOptions) -> int:
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

    from .native_pipeline import extends_on_device, prewarm_device

    prewarm = None
    if not opt.only_gen_index and extends_on_device(opt.use_tpu, aln_params):
        # build the kernels, create the CUDA context and run the int16
        # probe while the index is built or read, where the run will
        # extend on the device. An -i run never maps
        prewarm = prewarm_device(opt.device)

    index = StrobemerIndex(references, index_parameters, opt.bits)
    mmap_ok = False  # opened from the sidecar, whose warmer thread runs
    if opt.use_index:
        sti_path = opt.ref_filename + index_parameters.filename_extension()
        logger.info(f"Reading index from {sti_path}")
        t0 = time.perf_counter()
        if opt.mmap_index:
            # O(1) open of the columnar sidecar; pages fault in while a
            # warmer thread streams the files through the page cache. A
            # missing or stale sidecar means a plain read, then the sidecar
            mmap_ok = index.read_mmap(sti_path)
            if mmap_ok:
                logger.info("Index mapped from columnar sidecar")
            else:
                index.read(sti_path)
                logger.info("Building mmap sidecar (one-time) ...")
                index.write_columns(sti_path)
        else:
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
            # the sidecar is a second full copy of the arrays: --no-sidecar
            # skips it, and a failed write only warns, since the .sti is
            # the real artifact and --mmap-index builds a missing sidecar
            if not opt.no_sidecar:
                logger.info("Writing mmap sidecar (columnar)")
                try:
                    index.write_columns(sti_path)
                except OSError as e:
                    logger.warning(f"sidecar write failed ({e}); the .sti is intact "
                                   f"and the first --mmap-index run builds the sidecar")
            return 0

    if not mmap_ok and index.hashes.nbytes > (1 << 30):
        # a big freshly read or built index pays a first-pass page-mapping
        # penalty; a short random-access burst absorbs it while mapping
        # starts (the sidecar's warmer does this itself)
        from ..index.strobemer_index import warm_index_random_access

        threading.Thread(target=warm_index_random_access,
                         args=(index.hashes, index.positions, index.randstrobe_start_indices),
                         daemon=True).start()

    map_param.rescue_cutoff = (
        map_param.rescue_level * index.filter_cutoff
        if map_param.rescue_level < 100
        else 1000
    )
    logger.debug(f"Using rescue cutoff: {map_param.rescue_cutoff}")

    if prewarm is not None:
        # a kernel library that does not build, or a probe that does not
        # launch, fails the run here, before any output is written
        prewarm.result()

    if opt.num_nodes > 1:
        if native_disabled():
            # N pod hosts on the Python mapper would all map the whole input
            # into the same output file
            raise RuntimeError(f"--num-nodes > 1 requires the native engine, which "
                               f"{NO_NATIVE_ENV} turns off")
        # each host writes its own shard beside -o; node 0 merges them
        with _profiler(opt):
            _map_pod(opt, references, index, index_parameters, map_param, aln_params)
    else:
        # binary output end-to-end: the engine produces ASCII SAM/PAF bytes
        out = (
            sys.stdout.buffer if opt.write_to_stdout
            else open(opt.output_file_name, "wb")
        )
        try:
            with _profiler(opt):
                _map_reads(opt, out, references, index, index_parameters, map_param,
                           aln_params)
            out.flush()
        finally:
            if not opt.write_to_stdout:
                out.close()
    logger.info("Done!")
    logger.info(f"Total time mapping: {time.perf_counter() - t_start:.2f} s.")
    return 0


def _profiler(opt):
    """``--profile DIR``: one torch.profiler trace of the mapping run, the
    counterpart of the JAX runner's jax.profiler.trace. CPU ops of every
    thread (the mapping workers dispatch from their own), and with the
    device path on CUDA the card's kernels and copies. On exit the trace
    is written to DIR as ``<host>_<pid>.<ns>.pt.trace.json``, which
    TensorBoard and Perfetto read. Nothing catches the profiler's errors:
    one raised when it starts or when it writes the trace fails the run."""
    if opt.profile_dir is None:
        return contextlib.nullcontext()
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if opt.use_tpu and opt.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(opt.profile_dir),
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


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
    from .native_pipeline import NativePipeline, ThreadedNativePipeline

    if map_param.is_sam_out:
        out.write(
            sam_header(references, opt.read_group_id, opt.read_group_fields,
                       " ".join(sys.argv)).encode()
        )
    if native_disabled():
        _map_reads_python(opt, out, references, index, index_parameters, map_param, aln_params)
        return
    if opt.n_threads > 1:
        pipeline = ThreadedNativePipeline(
            index, index_parameters, references, aln_params, map_param,
            opt.read_group_id, use_device=opt.use_tpu, batch_size=opt.tpu_batch,
            n_workers=opt.n_threads, device=opt.device,
            deterministic=opt.deterministic, device_seed=opt.device_seed,
            shard_index=opt.shard_index, pin_workers=opt.pin_workers,
        )
    else:
        pipeline = NativePipeline(
            index, index_parameters, references, aln_params, map_param,
            opt.read_group_id, use_device=opt.use_tpu, batch_size=opt.tpu_batch,
            device=opt.device, device_seed=opt.device_seed, shard_index=opt.shard_index,
        )
    if opt.shard_index:
        _log_sharded_index(pipeline.sharded_index)
    t0 = time.perf_counter()
    # no retry-from-scratch fallback: map_file writes output
    # incrementally, so re-running after a mid-run failure would append
    # duplicate records — let the error propagate
    n_reads = pipeline.map_file(
        opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
        opt.chunk_size, out.write, progress=_make_progress(opt, t0),
    )
    _log_mapping(opt, pipeline, n_reads, time.perf_counter() - t0)


def _map_reads_python(opt, out, references, index, index_parameters, map_param,
                      aln_params) -> None:
    """The Python mapper (rabbitsalign_tpu/pipeline/runner.py's branch for
    a host without the native library): chunk by chunk, phase A
    (`phase_a_chunk`), the chunk's gapped extensions dispatched to the
    BatchAligner, then phase B of the previous chunk while the device
    extends this one, each chunk with its own MinstdRand seeded with its
    index (the reference's per-chunk engine, src/pc.cpp:583,706,801)."""
    from ..align.aligner import Aligner
    from ..io.fastq import InputBuffer
    from ..io.sam import CIGAR_OPS_EQX, CIGAR_OPS_M, Sam
    from ..map.common import InsertSizeDistribution
    from ..map.randomness import MinstdRand
    from ..map.stats import AlignmentStatistics
    from ..ops.batch_extend import BatchAligner, HostBatchAligner
    from .batched import phase_a_chunk, phase_b_chunk

    idle = [flag for flag, on in (("-t", opt.n_threads > 1), ("--device-seed", opt.device_seed),
                                  ("--shard-index", opt.shard_index)) if on]
    if idle:
        logger.info(f"{NO_NATIVE_ENV}: the Python mapper runs one thread with host seeding; "
                    f"{', '.join(idle)} do not apply")
    aligner = Aligner(aln_params)
    statistics = AlignmentStatistics()
    isize_est = InsertSizeDistribution()
    cigar_ops = CIGAR_OPS_EQX if opt.cigar_eqx else CIGAR_OPS_M
    if opt.use_tpu:
        batch_aligner = BatchAligner(aln_params, opt.tpu_batch, device=opt.device)
    else:
        batch_aligner = HostBatchAligner(aln_params)
    input_buffer = InputBuffer(opt.reads_filename1, opt.reads_filename2, opt.chunk_size,
                               opt.is_interleaved)

    def finish(prev) -> None:
        work, token, engine, paf_out = prev
        infos = batch_aligner.collect(token)
        sam = Sam(references, cigar_ops, opt.read_group_id, opt.output_unmapped, opt.details)
        phase_b_chunk(work, infos, sam, statistics, isize_est, aligner, map_param,
                      index_parameters, references, engine)
        out.write(sam.take().encode() if map_param.is_sam_out else "".join(paf_out).encode())

    n_reads = 0
    t0 = time.perf_counter()
    pending = None  # (work, token, engine, paf_out) of the previous chunk
    for chunk_index, records1, records2, records3 in input_buffer.chunks():
        engine = MinstdRand(0)
        engine.seed(chunk_index)
        paf_out = []
        work, n = phase_a_chunk(records1, records2, records3, paf_out, isize_est, aligner,
                                batch_aligner, map_param, index_parameters, references, index,
                                engine)
        n_reads += n
        token = batch_aligner.dispatch()
        if pending is not None:
            finish(pending)
        pending = (work, token, engine, paf_out)
    if pending is not None:
        finish(pending)

    statistics.n_reads = n_reads
    statistics.tot_aligner_calls = aligner.calls_count()
    elapsed = time.perf_counter() - t0
    logger.info(f"Mapped {n_reads} reads in {elapsed:.2f} s "
                f"({n_reads / max(elapsed, 1e-9):.0f} reads/s)")
    logger.info(f"Total mapping sites tried: {statistics.tot_all_tried}")
    logger.info(f"Total calls to ssw: {statistics.tot_aligner_calls}")
    logger.info(f"Inconsistent NAM ends: {statistics.inconsistent_nams}")
    logger.info(f"Tried NAM rescue: {statistics.nam_rescue}")
    logger.info(f"Mates rescued by alignment: {statistics.tot_rescued}")
    if isinstance(batch_aligner, BatchAligner):
        logger.info(f"Device extend: {batch_aligner.n_device_jobs} jobs on {batch_aligner.device}, "
                    f"{batch_aligner.n_host_jobs} refused by every bucket, "
                    f"{batch_aligner.n_fallbacks} redone on the host")
    logger.debug(f"Kernel launches: {json.dumps(_kernel_launches())}")


def _log_sharded_index(si) -> None:
    logger.info(f"Sharded index: {si.n_shards} shard(s) on "
                f"{', '.join(map(str, si.devices))}, {si.shard_sizes} randstrobes "
                f"({si.width} entries a shard with padding), built in {si.build_s:.2f} s")


def _log_mapping(opt, pipeline, n_reads: int, elapsed: float) -> None:
    """The mapping loop's reads/s, the engine's counters and phase times,
    and the lookups' or the device seeding's share of phase A."""
    c = pipeline.counters()
    logger.info(f"Mapped {n_reads} reads in {elapsed:.2f} s "
                f"({n_reads / max(elapsed, 1e-9):.0f} reads/s)")
    logger.info(f"Total mapping sites tried: {c['tot_all_tried']}")
    logger.info(f"Total calls to ssw: {c['aligner_calls']}")
    logger.info(f"Inconsistent NAM ends: {c['inconsistent_nams']}")
    logger.info(f"Tried NAM rescue: {c['nam_rescue']}")
    logger.info(f"Mates rescued by alignment: {c['tot_rescued']}")
    tm = pipeline.timers()
    # summed over workers with -t > 1: thread-seconds, not wall time
    logger.info(
        "Phase times: seeding+NAMs %.2f s, phase A total %.2f s, extend dispatch %.2f s, "
        "device results in %.2f s, host alignment %.2f s, pairing+output %.2f s, "
        "output copy and chunk release %.2f s"
        % (tm["seed_nam_s"], tm["phase_a_s"], tm["dispatch_s"], tm["device_results_s"],
           tm["host_align_s"], tm["phase_b_s"], tm["chunk_out_s"])
    )
    logger.info(
        "Waits: reader %.2f s, hand-off %.2f s, worker set-up %.2f s, input %.2f s, device "
        "%.2f s, ordered output %.2f s; mapping threads %.2f s"
        % (tm["read_wait_s"], tm["handoff_wait_s"], tm["worker_setup_s"], tm["input_wait_s"],
           tm["device_wait_s"], tm["emit_s"], tm["worker_s"]))
    if opt.use_tpu:
        logger.info(f"Device extend: {c['device_jobs']} jobs, {c['device_cells']} DP cells in "
                    f"{sum(pipeline.dispatches())} batches ({c['native_batches']} native) of "
                    f"{c['chunks']} chunks, "
                    f"{c['upload_bytes'] / 1e6:.1f} MB uploaded; on the host "
                    f"{c['small_to_host']} in small batches, {c['unbucketed']} unbucketed, "
                    f"{c['fallbacks']} rejected; {c['planned_jobs']} planned, "
                    f"{c['tight_jobs']} in the tight bucket")
    if len(pipeline.dispatches()) > 1:
        logger.info(f"Extend dispatches an entry of the device list: {pipeline.dispatches()}")
    if pipeline.sharded_index is not None:
        # the lookups' share of phase A, beside the engine's seeding
        logger.info(f"Sharded lookups: {tm['shard_lookup_s']:.2f} s, rescue preflight "
                    f"{tm['rescue_preflight_s']:.2f} s, feed misses {c['feed_miss']}")
    elif pipeline.device_seed:
        # the device's share of phase A, which the engine's timers do not see
        logger.info(f"Device seeding: {tm['device_seed_s']:.2f} s, "
                    f"{c['host_seeded']} tie or long reads seeded on the host, "
                    f"{c['host_walked']} reads' runs walked on the host")


def _kernel_launches() -> dict:
    """This process's extend dispatches and kernel launches so far."""
    from ..ops import (chain_cuda, extend_device, int16_probe, seed_cuda, shard_cuda, sw_cuda,
                       tb_cuda)

    return {"extend_dispatches": extend_device.calls,
            "extend_packed": extend_device.packed_calls, "sw_forward": sw_cuda.launches,
            "sw_forward_i16": sw_cuda.launches_i16, "sw_traceback": tb_cuda.launches,
            "int16_probe": int16_probe.launches, "seed_randstrobes": seed_cuda.launches_seed,
            "index_find": seed_cuda.launches_find, "walk_hits": chain_cuda.launches_walk,
            "find_runs": shard_cuda.launches_find_runs}


def _map_pod(opt, references, index, index_parameters, map_param, aln_params) -> None:
    """One host of a multi-host pod run (rabbitsalign_tpu's runner pod
    branch): join the gloo group, map this host's chunks on one mapping
    thread into its output shard, sum the statistics over the pod, and on
    node 0 merge the shards (SAM header first) after a barrier. With
    --pod-index-peers this host keeps only its slice of the index, and
    the host arrays are emptied so that a stray host-index access fails
    loudly."""
    import numpy as np

    from ..parallel.multihost import (PodShardedIndex, ShardWriter, barrier, init_distributed,
                                      merge_output, psum_statistics, shutdown_distributed)
    from ..parallel.sharding import make_mesh
    from .native_pipeline import NativePipeline

    pid, pcount = init_distributed(opt.coordinator, opt.num_nodes, opt.node_id)
    pod_index = None
    try:
        shard_flag = opt.shard_index
        if opt.pod_index_peers:
            peers = opt.pod_index_peers.split(",")
            if len(peers) != pcount:
                raise RuntimeError(f"--pod-index-peers lists {len(peers)} endpoints for a "
                                   f"{pcount}-host pod")
            pod_index = PodShardedIndex(index, pid, pcount, peers,
                                        make_mesh(1, opt.device)[0])
            index.hashes = np.zeros(0, dtype=np.uint64)
            index.positions = np.zeros(0, dtype=np.uint32)
            index.packed = np.zeros(0, dtype=np.uint32)
            shard_flag = True
            logger.info(f"Pod-sharded index: host {pid} holds {pod_index.size} of the "
                        f"randstrobes ({pod_index.nbytes / 1e9:.2f} GB slice) on "
                        f"{pod_index.device}, built in {pod_index.build_s:.2f} s")
        pipeline = NativePipeline(
            index, index_parameters, references, aln_params, map_param,
            opt.read_group_id, use_device=opt.use_tpu, batch_size=opt.tpu_batch,
            device=opt.device, device_seed=opt.device_seed, shard_index=shard_flag,
            sharded_index=pod_index,
        )
        if pod_index is None and shard_flag:
            _log_sharded_index(pipeline.sharded_index)
        if opt.n_threads > 1 or opt.deterministic:
            logger.info("multi-host mode runs one mapping thread per host; "
                        "-t/--deterministic apply to single-host runs")
        writer = ShardWriter(opt.output_file_name, pid, pcount)
        t0 = time.perf_counter()
        try:
            n_reads = pipeline.map_file_sharded(
                opt.reads_filename1, opt.reads_filename2, opt.is_interleaved,
                opt.chunk_size, writer, pid, pcount,
            )
        finally:
            writer.close()
        _log_mapping(opt, pipeline, n_reads, time.perf_counter() - t0)
        logger.debug(f"Host {pid}/{pcount} kernel launches: {json.dumps(_kernel_launches())}")
        if pod_index is not None:
            logger.info(f"Pod index traffic of host {pid}: {json.dumps(pod_index.stats)}")
        stats_sum = psum_statistics({"n_reads": n_reads, **pipeline.counters()})
        barrier()
        if pid == 0:
            t1 = time.perf_counter()
            header = ""
            if map_param.is_sam_out:
                header = sam_header(references, opt.read_group_id, opt.read_group_fields,
                                    " ".join(sys.argv))
            merge_output(opt.output_file_name, pcount, header)
            logger.info(f"Merged {pcount} output shards into {opt.output_file_name} in "
                        f"{time.perf_counter() - t1:.2f} s")
        logger.info(f"Host {pid}/{pcount}: mapped {n_reads} reads in "
                    f"{time.perf_counter() - t0:.2f} s; pod total {stats_sum['n_reads']:.0f}")
    finally:
        if pod_index is not None:
            pod_index.close()
        shutdown_distributed()
