"""The system under test: rabbitsalign_tpu_torch's main path, built the
way pipeline/runner.py:run_aligner builds it for the CLI's default run
(an index built in memory, the device prewarm, `ThreadedNativePipeline`
with the CLI's defaults), with a configuration's `options` applied over
those defaults by name.

Only this module and the window import the program.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class System:
    pipeline: object  # ThreadedNativePipeline
    index_load_s: float


def options(config: dict, paired: bool):
    """The CLI's options for this configuration: its defaults, the
    configuration's `options` over them, and the input's layout."""
    from rabbitsalign_tpu_torch.cli import CommandLineOptions

    opt = CommandLineOptions()
    for key, value in config.get("options", {}).items():
        if not hasattr(opt, key):
            raise KeyError(f"configuration option {key!r} is not a CLI option")
        setattr(opt, key, value)
    opt.is_interleaved = paired
    opt.is_SE = not paired
    return opt


def build(config: dict, genome, opt, device: str) -> System:
    """The genome as the program's References, the index built from it
    with the CLI's parameters (timed: `index_load_s`), and the pipeline,
    after the device prewarm (kernel library, CUDA context, int16 probe)
    has finished."""
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.index.params import DEFAULT, IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References
    from rabbitsalign_tpu_torch.map.common import MappingParameters
    from rabbitsalign_tpu_torch.pipeline.native_pipeline import (ThreadedNativePipeline,
                                                                 prewarm_device)

    references = References()
    for (name, _), codes in zip(config["contigs"], genome):
        references.add(name, ACGT[codes].tobytes())
    index_parameters = IndexParameters.from_read_length(
        opt.r, *(getattr(opt, f) if getattr(opt, f"{f}_set") else DEFAULT
                 for f in ("k", "s", "l", "u", "c")),
        opt.max_seed_len if opt.max_seed_len_set else DEFAULT)
    aln_params = AlignmentParameters(match=opt.A, mismatch=opt.B, gap_open=opt.O,
                                     gap_extend=opt.E, end_bonus=opt.end_bonus)
    map_param = MappingParameters(
        r=opt.r, max_secondary=opt.max_secondary, dropoff_threshold=opt.dropoff_threshold,
        rescue_level=opt.rescue_level, max_tries=opt.max_tries, is_sam_out=opt.is_sam_out,
        cigar_eqx=opt.cigar_eqx, output_unmapped=opt.output_unmapped, details=opt.details,
        pe_ref_async=opt.pe_ref_async)
    map_param.verify()

    prewarm = None
    if device == "cuda" and opt.use_tpu and aln_params.gap_extend < aln_params.gap_open:
        prewarm = prewarm_device(device)
    t0 = time.perf_counter()
    index = StrobemerIndex(references, index_parameters, opt.bits)
    index.populate(opt.f, opt.n_threads)
    index_load_s = time.perf_counter() - t0
    map_param.rescue_cutoff = (map_param.rescue_level * index.filter_cutoff
                               if map_param.rescue_level < 100 else 1000)
    if prewarm is not None:
        prewarm.result()
    pipeline = ThreadedNativePipeline(
        index, index_parameters, references, aln_params, map_param, opt.read_group_id,
        use_device=opt.use_tpu, batch_size=opt.tpu_batch, n_workers=opt.n_threads,
        device=device, deterministic=opt.deterministic, device_seed=opt.device_seed,
        shard_index=opt.shard_index, pin_workers=opt.pin_workers)
    return System(pipeline=pipeline, index_load_s=index_load_s)
