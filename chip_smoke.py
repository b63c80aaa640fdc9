#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rabbitsalign_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure (a check, or an exception) exits non-zero
without the result line, and its last line, on stdout and on stderr, is
`chip_smoke: FAILED in phase <phase>: <the check>`:

1. Environment: a CUDA device is present; the card's name and power
   limit (nvidia-smi), torch, CUDA and nvcc versions; g++ links -lz (the
   native engine needs zlib).
2. Build: the CUDA kernels (csrc/, one nvcc per source, all started
   together, for sm_90a; ptxas register, shared memory and spill lines,
   and each forward instantiation's registers and spills, with its loader
   (CodesIn, Q2In: the q2 forward at R = 5, 8, 16 must be there); a spill fails,
   except in the split forward at R = 16 and 4 pairs a warp, which is
   printed) and the native engine
   (g++), from the checkout's sources; build times.
3. Kernels against their plain PyTorch versions on the card, at each
   engine bucket shape at its production batch width, on planted, indel,
   N-run, tandem-repeat, junk, empty and >32-run pairs: forward outputs
   (score, t_end, q_end; dirs on valid cells), both traceback epilogues
   (runs and meta; the packed transfer buffer) and the fused packed
   transfer buffer (written by the traceback kernel) must be equal byte
   for byte (tolerance 0: everything is integer); so must the forward's
   q2 loader (`sw_forward_q2`, the main path's) and its codes loader on
   `unpack_q2`'s batch, and one native enqueue (`extend_q2_enqueue`) and
   the fused chain's buffer. The int16 forward (the
   RSB_SW16 configuration) must equal its plain int16 version and the
   int32 kernel byte for byte at the same shapes; a span-violating
   scoring must stay on int32; the int16 probe kernel must equal its
   plain version exactly on seeded tiles with the int16 extremes. The
   cross-pair ILP forward (`sw_forward_split`, 2 and 4 pairs a warp) must
   equal its plain version and the production forward (one warp per pair)
   byte for byte, dirs (B, Q, T) on valid cells. An empty kernel
   (csrc/launch_floor.cu) is timed on the card at the probe's and the
   traceback's grids: the floor of a launch that does no work.
   Kernel and plain times with CUDA events at the tight bucket, beside
   each kernel's bound (the larger of its bytes over 3.35 TB/s and its
   integer operations over the int32 rate) for this run's inputs. A
   kernel's time is its time on the card: its calls are queued behind a
   sleep kernel, so the host's enqueue time is hidden (the traceback's
   host-paced time, back-to-back calls, is printed beside it). Plain
   versions are timed host-paced; the fused extend and the one native
   enqueue both ways; the q2 forward against unpack_q2 + the forward on
   the card, with its registers, shared memory and spills (row 1q). At the
   tight bucket and at (512, 2048) the traceback's walks are replayed by
   the numpy emulation of its tile schedule (tests/torch_tb_tiles.py),
   which must give the kernel's runs and meta, for the longest and mean
   walk, its rounds, tile loads and prefetch hits; both epilogues are
   timed there, and ns per step of the longest walk is printed.
ILP. The ILP probe harness (tools/ilp_probe.py) as its user runs it, with
   the launch counts set to 0 before it: the split kernels held bit-exact
   against the production kernel and (here) their plain versions on the
   harness's inputs, then paired-slope
   times at (152, 256) x 1024 for production, split2 and split4, and each
   split's time over production's; then the three on the card, queued
   behind a sleep kernel, in turns.
Data. A 40 Mbp simulated genome (bench.py's generator), 240k x 150 bp SE
   reads and 120k x 2x150 bp PE pairs (24 chunks each, so each of 3 workers
   maps several); the index built once with `-i` (which also writes the
   `--mmap-index` sidecar).
Seed. The seeding kernels of the main path against their plain PyTorch
   versions on the card, tolerance 0 on every output: `seed_randstrobes`
   (counts, offsets, the total and the compacted strobes in one buffer,
   nothing written past them in its worst-case allocation) on a chunk's
   shape (the first 10 000 SE reads x 256 codes) plus edge reads (lengths
   0, 11, 150, 256 and 300, all-N, N runs, tandem repeats that make tie
   rows), and `index_find` against the 40 Mbp index (64 MB of hashes and a
   17 MB bucket table, larger than the 50 MB L2) on that chunk's strobes,
   the smallest hash (unreachable: -1) and random misses, into the seeding
   buffer, and on an index whose hashes are all equal. Times on the card
   (the seeding also after an L2 flush and host-paced with its read of the
   total), plain times, the bound at this run's s-mers, syncmers and
   candidates, and for the lookup one `torch.searchsorted` over the
   sign-flipped hashes as the library call, the distinct 32-byte sectors
   its queries touch (the bucket pair's, the binary search's and the
   equality read's, replayed with torch ops) as a floor beside the bound,
   and an empty kernel at the lookup's grid.
Shard. The run lookup of `--shard-index` (csrc/find_runs.cu, a search
   bounded by the bucket table, then a compacting gather) on the 40 Mbp
   index cut into 1 and 4 shards of the one card: the three lookups of
   `ShardedIndex` (every shard searching every key, dense; routed at cap 2,
   so that runs are longer than the cap; routed and compacted, as phase A
   uses it) on the first SE chunk's strobes (seeded on the host by the
   engine), 4096 misses, the sentinel hash and the smallest hash must equal
   the same index's on the CPU (the plain versions), tolerance 0; and the
   kernels' wrappers their plain versions on the same card tensors. The
   same on an index of runs of 1 to 120 rows (tests/torch_gather_lanes.py
   `RunsIndex`: runs over 32 rows and over the cap) at caps 2, 40 and the
   filter cutoff, and its gather at cap 40 dense, at the pod's offsets and
   with keys skipped. At one shard, the main path's shape, the search and
   the compacting gather timed on the card together and each alone, after
   an L2 flush and back to back, the search also over a one-bit bucket
   table (a whole-shard search's depth); the plain time, the bound with the
   search's probes replayed (`lookup_probes`) and their 32-byte sectors,
   and one `torch.searchsorted` as the library call.
Chain. The device NAM front end (no CLI path runs it, as in the JAX
   package) on the same 40 Mbp index, uploaded for it
   (`upload_index_split`), and the first SE chunk's 10 000 reads. Its path,
   with the launch counts set to 0 before it and read after:
   `find_nams_composed_batch` on the chunk (the seeding and lookup
   kernels, then csrc/walk_hits.cu, the host ordering and one
   csrc/merge_hits.cu launch), `find_nams_device_chain` on 200 of its
   reads, and `randstrobes_query_device` on the chunk
   (csrc/syncmers_scan.cu); every kernel of it must have launched. On every
   read it does not flag, the composed batch must equal the engine's
   `find_nams_chunk` (rescue level 0: the nonrepetitive fraction and every
   NAM field the merge carries, the score as float32), and it may flag at
   most 2% of the chunk (long, tie, hit or merge overflow reads, printed);
   the device chain must equal chain/nams.find_nams; the G-ary split
   lookup must equal the index_find kernel on the chunk's strobes; the
   exact seeder must equal the vectorised one on the rows it does not flag
   and the host randstrobes_query on its tie rows. The three kernels
   against their plain versions, tolerance 0: the scan on the chunk and on
   10 000 tie-heavy reads (tests/torch_seed_cases.py `tie_reads`: tandem
   repeats of 1-29 bp units, homopolymers, N runs, where the scan replays
   its automaton), the walk on the chunk's strobes in both layouts (the
   dense (N, 192, 6) of the composed batch, and the compact one of the
   main path, `walk_hits_compact` at cap = cutoff = the filter cutoff),
   on the 80-copy repeat of `long_runs_world` (runs of ~80 rows; compact
   too, where reads overflow their room) and on `mixed_runs` (runs of 1
   to 80 rows in one round), the merge on every stream of the chunk at
   caps 32, 4 (where streams overflow) and 200, and on its boundary
   streams (tests/torch_chain_cases.py `merge_edge_streams`, more than 128
   NAMs open among them) at caps 200, 129, 65, 33, 32, 8 and 3. Each
   kernel's time after an L2 flush and back to back, plain time, bound
   and launches (the walk's in the compact layout, with the dense
   layout's time beside it); the scan's time on the tie-heavy batch; the time of one
   merge launch of `find_nams_device_chain` (one read's streams, 20
   reads); for the merge (`merge_report`) the chunk's stream lengths, the
   streams and hits a lane and the warp take, the slowest warp's work, a
   lane's time a hit on one stream of 4096 hits, the chain floor (the
   longest stream's hits at that time) and one kernel a call
   (torch.profiler); the composed batch's wall time a chunk, host-paced, in four parts (the
   device front end with its copy back, the host ordering, the merge, the
   attribution) beside the engine's `find_nams_chunk` on the same chunk.
4. The main path through the CLI on that data: seven paths, each with the
   launch counts set to 0 before it and read after it, and each from a
   cold probe cache (so its prewarm runs the probe kernel):
   - `-t 1`: SE and PE, `--device cuda`;
   - the default run, 3 workers: SE with the default `-t` and PE with
     `--deterministic -t 3`;
   - the same with RSB_SW16=1 (the int16 forward);
   - SE, 3 workers, `--mmap-index` (the index opened from the sidecar);
   - SE, 3 workers, `--profile DIR`: the trace must hold both extend
     kernels, and the device busy share (the union of kernel and copy
     intervals over the trace's span) is printed;
   - `--shard-index` at `-t 1` (SE and PE) and with 3 workers (SE with the
     default `-t`, PE with `--deterministic -t 3`): `t1-shard`, `t3-shard`.
   Each device SAM must equal, apart from @PG, the host-only SAM
   (`--no-tpu`, host seeding) of the same threading, the `-t 1` device SAM
   (SE) and the int32 device SAM (RSB_SW16); the mmap and profile SAMs must
   equal the 3-worker SE SAM; the `--shard-index` SAMs the device SAMs of
   the same threading; the device runs must have dispatched extend
   batches, every kernel of a path must have launched in it: the seeding
   kernels in every path but the sharded ones (the default seeds on the
   card), and the run walk (csrc/walk_hits.cu) there once a chunk (as
   often as the seeding kernel), the run lookup in the sharded ones
   alone, which launch neither, and the sharded runs must report
   no feed misses. Each run's device seeding time and its tie-or-long
   reads, or its sharded lookups' time, are printed beside its phase
   times.

Multi. The CLI's 3-worker runs on a host whose local devices are the card
   named twice (`local_devices` made to return [cuda:0, cuda:0], as a
   two-card host's would name two cards): SE and PE (`--deterministic -t
   3`) with and without `--shard-index`. Each SAM must equal phase 4's
   `t3` or `t3-shard` SAM apart from @PG; the genome is uploaded once (one
   distinct card); each worker's extend batches are split over the two
   entries in turn (ceil(n/2), floor(n/2)) on one stream of its own on the
   card; the sharded index has one shard an entry; the forward, the
   traceback and, with --shard-index only, find_runs launched. The real
   `local_devices()` and the card count are printed; with one card, that
   no copy between cards ran.

Pod. The multi-host pod run on the one card: two CLI processes
   (`python -m rabbitsalign_tpu_torch.cli --num-nodes 2`, the checkout on
   PYTHONPATH, a free coordinator port from the OS, `-t 1`, `-v`, `-o`),
   started together, each from a cold probe cache: `pod2` SE (the merged
   SAM equal to `t1`'s apart from @PG), `pod2-shard` SE with
   `--pod-index-peers` (each host holds half the index on the card and
   serves the other's keys; equal to `t1`'s, no feed misses, find_runs
   launched in both processes), `pod2` PE (equal to the same pod with
   `--no-tpu`, since each host keeps its own insert-size state). Each
   device process's `-v` log must show forward and traceback launches;
   each host's mapping-loop reads/s, the pod total, node 0's merge time
   and the pod index's traffic are printed.

Py. The Python mapper (pipeline/batched.py, the JAX runner's branch for a
   host without its library), each part with the launch counts set to 0
   before it and read after: (a) through the library API with the
   engine's helpers loaded, `phase_a_chunk`, `BatchAligner` on the card
   (ops/extend_device.py:extend_batch_packed: the forward kernel, then the
   traceback kernel's packed epilogue) and `phase_b_chunk` over the first
   SE chunk (10 000 reads) and the first 5 000 pairs, each a chunk seeded
   with index 0: the SAM must equal the engine's CLI run (`-t 1`) on a
   FASTQ of just those reads, and both extend kernels must have launched
   (before it, `extend_batch_packed` at the three buckets x 512 mixed and
   gap pairs must equal the plain forward and packed walk on the card);
   reads/s with phase A, dispatch, collect and phase B apart, the jobs on
   the card, refused by every bucket and redone on the host; (b) the CLI
   under RABBITSALIGN_TPU_NO_NATIVE=1 in a subprocess, `--use-index`, on
   1 000 SE reads and 500 pairs: the SAM on the card must equal the same
   call's with `--no-tpu` apart from @PG, its `-v` launch line must show
   the extend kernels (none with `--no-tpu`); both reads/s; (c)
   `find_nams_sharded` on a one-shard ShardedIndex on the card must equal
   the host `find_nams` on 1 000 reads of the SE chunk, and
   `find_nams_rescue_sharded` the host rescue on 200, with find_runs
   launched; ms a read on both.
API. The public entry points no CLI path calls, with the launch counts set
   to 0 before it and read after: an engine at -t 1 for the first SE chunk
   (10 000 reads) and one for the first 5 000 pairs, the default buckets
   at the CLI's batch size (1024). Every planned batch is filled three ways
   (`fill_batch`, `fill_batch_q`, `fill_batch_q2`), uploaded, and extended
   by `extend_batch_packed`, `extend_batch_packed_resident`,
   `extend_batch_packed_resident_q2` and `extend_batch_packed_grouped` (at
   the plan's sub): the four outputs must be byte-equal; on one batch a
   bucket `extend_batch_device` (the forward and the unpacked traceback
   kernel, launched once) must give runs and meta that pack to the same
   rows. `job_shapes` must sum to the chunk's jobs (buckets plus
   unbucketed, and each histogram), and is printed; `isize_per_chunk` must
   be False, and True for an engine with `pe_ref_async` after the PE chunk.
   `sharded_find` on [cuda:0] of the chunk's host-seeded strobes, 4096
   random keys and the smallest hash must equal the host index's `find`;
   `data_parallel_extend` on [cuda:0] and on [cuda:0, cuda:0] must equal one
   `sw_forward` launch and the cells' sum. For each layout: its upload
   bytes a pair, its host-paced ms a batch for fill, upload, extend and
   copy back, and its extend's time on the card at the first (152, 256)
   batch.

The line before last is a JSON object with each kernel's launches in its
path (phases 4, Multi, Pod, Py and API; the ILP phase for sw_forward_split; phase
Chain for its own kernels, and the seeding and lookup kernels it runs), its
error against its plain version,
times, bound and library call; the last line is {"ok": true, "device":
{...}}. Work files go to build/chip_smoke/.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"  # git-ignored
DEVICE = "cuda"  # device 0
GENOME_BP = 40_000_000
N_SE_READS = 240_000
N_PE_PAIRS = 120_000
REQUIRED = ("rabbitsalign_tpu_torch/__init__.py", "rabbitsalign_tpu_torch/csrc/sw_forward.cu",
            "rabbitsalign_tpu_torch/csrc/sw_traceback.cu",
            "rabbitsalign_tpu_torch/csrc/int16_probe.cu",
            "rabbitsalign_tpu_torch/csrc/seed_randstrobes.cu",
            "rabbitsalign_tpu_torch/csrc/index_find.cu",
            "rabbitsalign_tpu_torch/csrc/find_runs.cu",
            "rabbitsalign_tpu_torch/csrc/bucket_search.cuh",
            "rabbitsalign_tpu_torch/csrc/syncmers_scan.cu",
            "rabbitsalign_tpu_torch/csrc/merge_hits.cu", "rabbitsalign_tpu_torch/csrc/walk_hits.cu",
            "rabbitsalign_tpu_torch/csrc/extend_q2.cu",
            "rabbitsalign_tpu_torch/native/engine.cpp", "rabbitsalign_tpu_torch/native/seednam.cpp",
            "rabbitsalign_tpu_torch/parallel/multihost.py",
            "rabbitsalign_tpu_torch/pipeline/batched.py",
            "rabbitsalign_tpu_torch/tools/ilp_probe.py", "bench.py", "tests/torch_extend_cases.py",
            "tests/torch_tb_tiles.py", "tests/torch_seed_cases.py", "tests/torch_chain_cases.py")
# kernel name -> (source, the pallas_call or, for the seeding and lookup
# kernels, the XLA function it replaces)
KERNELS = {
    "sw_forward": ("rabbitsalign_tpu_torch/csrc/sw_forward.cu",
                   "rabbitsalign_tpu/ops/sw_pallas.py:464"),
    "sw_forward_i16": ("rabbitsalign_tpu_torch/csrc/sw_forward.cu",
                       "rabbitsalign_tpu/ops/sw_pallas.py:464"),
    "sw_traceback": ("rabbitsalign_tpu_torch/csrc/sw_traceback.cu",
                     "rabbitsalign_tpu/ops/tb_pallas.py:254"),
    "int16_probe": ("rabbitsalign_tpu_torch/csrc/int16_probe.cu",
                    "rabbitsalign_tpu/ops/sw_pallas.py:105"),
    "sw_forward_split": ("rabbitsalign_tpu_torch/csrc/sw_forward.cu",
                         "tests/sanitize/ilp_probe.py:162"),
    "seed_randstrobes": ("rabbitsalign_tpu_torch/csrc/seed_randstrobes.cu",
                         "rabbitsalign_tpu/ops/seed_device.py:432"),
    "index_find": ("rabbitsalign_tpu_torch/csrc/index_find.cu",
                   "rabbitsalign_tpu/ops/seed_device.py:239"),
    "find_runs": ("rabbitsalign_tpu_torch/csrc/find_runs.cu",
                  "rabbitsalign_tpu/parallel/sharding.py:253"),
    "syncmers_scan": ("rabbitsalign_tpu_torch/csrc/syncmers_scan.cu",
                      "rabbitsalign_tpu/ops/seed_device.py:58"),
    "merge_hits": ("rabbitsalign_tpu_torch/csrc/merge_hits.cu",
                   "rabbitsalign_tpu/ops/chain_device.py:52"),
    "walk_hits": ("rabbitsalign_tpu_torch/csrc/walk_hits.cu",
                  "rabbitsalign_tpu/ops/front_device.py:80"),
}
SHARD_PATHS = ("t1-shard", "t3-shard")  # the paths that run the run lookup, and no seeding
POD_PATHS = ("pod2", "pod2-shard")  # phase Pod: two hosts on the one card
# the card's peak rates for the bounds (H100 SXM): HBM3 bytes/s, and int32
# operations/s = 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white paper;
# one operation per lane per cycle)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per DP cell of the forward (sw_cell's 30 and 3 for
# the row best, csrc/sw_forward.cu), per traceback step (load, two field
# extracts, op select, run compare and update, two index steps), and per
# probe element (compare, select)
OPS_PER_CELL = 33
OPS_PER_TB_STEP = 8
OPS_PER_PROBE_ELEM = 2
# int32-equivalent operations of the seeding kernel (a 64-bit add, xor,
# shift or compare as 2, a 64-bit multiply as 4): per s-mer of a read 80
# (a rolled 2-bit pack of both strands 14, the canonical minimum 3, xxh64
# 48, the window minimum 15); per syncmer 65 (its k-mer's pack and
# canonical minimum 17, xxh64 48); per strobe-2 candidate of a valid slot
# 12 (xor, mask, popcount, key, range check, compare-select). Its bytes:
# codes and lengths read once, the (B, 2M) hash, start and end slots, the
# counts and tie written once. The lookup: per search step 6 (the 64-bit
# compare and the update of the bounds); its bytes: each query read and
# each result written once, 16 bytes of bucket bounds and 8 bytes a probed
# hash (one a step, and the final equality read) a query.
OPS_PER_SMER = 80
OPS_PER_SYNCMER = 65
OPS_PER_LINK_CAND = 12
OPS_PER_FIND_STEP = 6
# the run lookup of --shard-index (search and compacting gather), per key:
# the key (8), its bucket bounds (16), its count and run offset written
# (16); 8 bytes a probed hash (the bucket-bounded search's steps, the
# final equality read, and for a found key the gallop's and the binary
# search's probes for its run's end, counted by lookup_probes); 16
# bytes a walked run row (positions and packed read, and written); 6
# operations a search step. The search's (gpos, count) that the gather
# reads back are the kernels' own round trip, not the function's bytes.
SHARD_KEY_BYTES = 8 + 16 + 16
SHARD_ROW_BYTES = 16
# the device NAM front end (phase Chain). The merge: 16 bytes read a hit,
# 28 written a NAM (its emission row), and 12 int32 operations a hit (the
# window and case tests against the NAM it joins, or its append: a floor,
# since the tests against the other open NAMs depend on the table). The
# walk: 16 bytes a strobe (its position and hash), 16 a walked run row
# (hash, position, packed), 24 a slot of the hits (kept or zero: the
# kernel writes every slot of a room), a strobe's in the compact layout of
# the main path and maxh a read in the dense (N, maxh, 6), 25 a read (its count and offset
# read, n_hits, total, good and overflow written). The scan seeder:
# OPS_PER_SMER an s-mer, and the codes read and its (B, M) outputs written
# once.
MERGE_HIT_BYTES = 16
MERGE_NAM_BYTES = 28
OPS_PER_MERGE_HIT = 12
WALK_STROBE_BYTES = 16
WALK_ROW_BYTES = 16
WALK_SLOT_BYTES = 24
WALK_READ_BYTES = 25


PHASE = "start"  # the phase running now, named by a failure


def fail(msg: str) -> None:
    """Print the failure in full on stderr, then one line that names the
    phase and the check on stderr and stdout, the last of both, and exit
    1, so that the failed check ends the output whatever runs after."""
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    check_line = " ".join(msg.strip().splitlines()[0].split())[:300] if msg.strip() else "?"
    line = f"chip_smoke: FAILED in phase {PHASE}: {check_line}"
    print(line, file=sys.stderr, flush=True)
    print(line, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    global PHASE
    PHASE = name
    say(f"== phase {name}")


def run_cmd(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600, **kw)


def environment():
    phase("1: environment")
    missing = [rel for rel in REQUIRED if not (ROOT / rel).is_file()]
    check(not missing, f"not a checkout of the repository (missing {missing})")
    sys.path.insert(0, str(ROOT))
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    from rabbitsalign_tpu_torch.ops.cuda_build import nvcc_path

    nvcc = run_cmd([nvcc_path(), "--version"])
    check(nvcc.returncode == 0, f"nvcc --version failed: {nvcc.stderr}")
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc.stdout.strip().splitlines()[-1]}, device 0: {torch.cuda.get_device_name(0)}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    src = WORK / "zlib_check.c"
    src.write_text('#include <zlib.h>\nint main(void){return zlibVersion()[0] ? 0 : 1;}\n')
    gxx = run_cmd(["g++", "-x", "c++", str(src), "-o", str(WORK / "zlib_check"), "-lz"])
    check(gxx.returncode == 0, f"g++ cannot link -lz: {gxx.stderr}")
    check(run_cmd([str(WORK / "zlib_check")]).returncode == 0, "zlib check program failed")
    say("g++ links -lz: ok")
    return torch, card


def build():
    phase("2: build")
    from rabbitsalign_tpu_torch.ops import cuda_build

    cuda_build.build_kernels(extra_flags=("-Xptxas", "-v"))
    say(f"CUDA kernels built in {cuda_build.build_seconds:.2f} s -> "
        f"{cuda_build.LIB_PATH.relative_to(ROOT)}")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say("  " + line.strip())
    entries = ptxas_entries(cuda_build.build_log)
    for name, (regs, spill) in entries.items():
        m = re.search(r"sw_forward_warp_kernelI([is])Li(\d+)E.*?(CodesIn|Q2In)", name)
        if m:
            say(f"sw_forward_warp_kernel<{'int32' if m.group(1) == 'i' else 'int16'}, "
                f"R = {m.group(2)}, {m.group(3)}>: {regs} registers, {spill} bytes spilled")
        m = re.search(r"sw_forward_split_kernelILi(\d+)ELi(\d+)EE", name)
        if m:
            say(f"sw_forward_split_kernel<R = {m.group(1)}, PAIRS = {m.group(2)}>: {regs} "
                f"registers, {spill} bytes spilled")
        if "merge_hits_kernel" in name:
            say(f"merge_hits_kernel: {regs} registers, {spill} bytes spilled")
    # the split forward (off the mapping path) at R = 16 and 4 pairs a
    # warp spills: printed above, not a failure; any other spill is
    spilled = [name for name, (_, spill) in entries.items()
               if spill and "sw_forward_split_kernelILi16ELi4EE" not in name]
    check(not spilled, f"ptxas reports register spills in {spilled}")
    check(sum("Q2In" in name and "sw_forward_warp_kernel" in name for name in entries) == 6,
          "ptxas lists no int32 and int16 q2 forward at R = 5, 8 and 16")
    # a fresh engine cache inside the checkout: always built from its sources
    os.environ["RABBITSALIGN_TPU_TORCH_CACHE"] = str(WORK / "engine_cache")
    from rabbitsalign_tpu_torch.native import build_engine

    t0 = time.perf_counter()
    path = build_engine()
    say(f"native engine built in {time.perf_counter() - t0:.2f} s -> {path.relative_to(ROOT)}")
    return entries


def ptxas_entries(log: str):
    """{function: (registers, spill store + load bytes)} from the
    `-Xptxas -v` lines of a build (each spill line is the function's named
    just before it)."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            name = m.group(1)
            entries.setdefault(name, [0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            entries[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            entries[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in entries.items()}


def empty_ms(torch, blocks: int, threads: int) -> float:
    """Milliseconds on the card of an empty kernel of `blocks` x `threads`
    (csrc/launch_floor.cu): the fixed cost of a launch at that grid."""
    from rabbitsalign_tpu_torch.ops.cuda_build import load_kernels

    lib = load_kernels()

    def call():
        check(lib.empty_launch(blocks, threads, torch.cuda.current_stream().cuda_stream) == 0,
              "the empty kernel's launch failed")

    return device_ms(torch, call, 100)


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card, by CUDA events: after a
    warm-up call, the calls are queued behind a sleep kernel, so the
    events time the card's work and not the host's enqueueing. The sleep
    grows until the host has queued every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail("the host could not queue the timed calls ahead of the card")


def bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def forward_bound(q_t, t_t, qlen, tlen):
    """The forward's bound on these inputs: its valid cells' operations,
    against the codes and lengths read once, the valid cells' direction
    bytes and the three (B,) int32 results written once."""
    (Q, B), T = q_t.shape, t_t.shape[0]
    cells = int((qlen.clamp(0, Q).long() * tlen.clamp(0, T).long()).sum())
    return bound((Q + T) * B + 8 * B + cells + 12 * B, OPS_PER_CELL * cells)


def traceback_bound(score, t_end, q_end, meta):
    """The bound of the packed traceback, which the main path launches:
    each aligned pair walks at least max(query span, target span) cells;
    it reads those direction bytes and the three (B,) inputs, and writes
    the (78, B) u8 transfer rows."""
    B = score.shape[0]
    span = (t_end - meta[0]).maximum(q_end - meta[1]) + 1
    steps = int(span.where(score > 0, 0).clamp(min=0).sum())
    return bound(steps + 12 * B + 78 * B, OPS_PER_TB_STEP * steps)


def walk_stats(torch, card, tag, dirs, score, t_end, q_end, kernel_runs, B):
    """Replay the batch's walks through the numpy emulation of the
    traceback's tile schedule, hold it to the kernel's runs and meta, time
    both epilogues on the card, and print the walks' lengths, rounds, tile
    loads, prefetch hits and ns per step of the longest walk, and the
    packed wrapper's host-paced time. Returns the packed epilogue's ms."""
    from rabbitsalign_tpu_torch.ops import tb_cuda
    from tests.torch_tb_tiles import K_KERNEL, tile_walk_batch

    t0 = time.perf_counter()
    got, st = tile_walk_batch(dirs.cpu().numpy(), *(x.cpu().numpy() for x in (score, t_end, q_end)),
                              K_KERNEL)
    emu_s = time.perf_counter() - t0
    check(all((g == k.cpu().numpy()).all() for g, k in zip(got, kernel_runs)),
          f"{tag}: the tile-schedule emulation disagrees with the kernel")
    on = (score > 0).cpu().numpy()
    steps, rounds, loads, hits = (st[k][on] for k in ("steps", "rounds", "loads", "hits"))
    ms = {fn: device_ms(torch, lambda: getattr(tb_cuda, fn)(dirs, score, t_end, q_end), 50)
          for fn in ("sw_traceback_packed", "sw_traceback")}
    host = time_ms(torch, lambda: tb_cuda.sw_traceback_packed(dirs, score, t_end, q_end), 50)
    # the fixed cost: every walk one cell long (from (0, 0)), so a call is
    # the launch, the inputs' read, one tile's copy and the epilogue
    zero = torch.zeros_like(t_end)
    fixed = device_ms(torch, lambda: tb_cuda.sw_traceback_packed(dirs, score, zero, zero), 50)
    longest = int(steps.max())
    say(f"traceback walks at {tag} B={B} ({int(on.sum())} aligned, emulation equal to the kernel, "
        f"{emu_s:.1f} s): longest {longest} steps in "
        f"{int(rounds[steps.argmax()])} rounds, mean {steps.mean():.1f} steps in "
        f"{rounds.mean():.2f} rounds (most rounds {int(rounds.max())}); per walk "
        f"{loads.mean():.3f} synchronous tile loads and {hits.mean():.3f} prefetch hits "
        f"({K_KERNEL}-row tiles)")
    for fn, t in ms.items():
        say(f"{fn} at {tag} B={B}: {t:.4f} ms on the card "
            f"({t * 1e3 / B:.4f} us/pair), {t * 1e6 / longest:.1f} ns per step of the longest "
            f"walk [{card}]")
    say(f"sw_traceback_packed at {tag} B={B}: {host:.4f} ms a call host-paced (back-to-back "
        f"calls through the wrapper); {fixed:.4f} ms on the card with every walk one cell long "
        f"[{card}]")
    return ms["sw_traceback_packed"]


def forward_geometry(Q: int, T: int):
    """(rows per lane R, dynamic shared memory of one 4-warp block in
    bytes) of the forward kernel at (Q, T), as csrc/sw_forward.cu picks
    them: the smallest R of 1, 2, 4, 5, 8, 16 with 32 R >= Q; per warp
    a ring of 32 x (64 R + 32) bytes and the T target codes rounded up
    to 16."""
    R = next(r for r in (1, 2, 4, 5, 8, 16) if 32 * r >= Q)
    return R, 4 * (32 * (64 * R + 32) + (T + 15) // 16 * 16)


def max_abs_err(torch, pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
               for a, b in pairs)


@contextlib.contextmanager
def sw16(value):
    """RSB_SW16 set to `value` (None: unset) inside the block."""
    old = os.environ.pop("RSB_SW16", None)
    if value is not None:
        os.environ["RSB_SW16"] = value
    try:
        yield
    finally:
        os.environ.pop("RSB_SW16", None)
        if old is not None:
            os.environ["RSB_SW16"] = old


def kernels(torch, card, entries):
    phase("3: kernels against their plain versions")
    from rabbitsalign_tpu_torch.native.engine import engine_buckets
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import int16_probe as probe
    from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda
    from tests.torch_extend_cases import mixed_pairs, q2_batch

    dev = torch.device(DEVICE)
    sw = sw_cuda.SwParams(2, 8, 12, 1)
    err = {name: 0 for name in KERNELS}
    times, bounds = {}, {}
    for i, (Q, T, bcap, groups) in enumerate(engine_buckets(150)):
        B = bcap * groups  # the widest dispatch the planner makes
        buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=Q * T), Q, seed=Q)
        buf = torch.from_numpy(buf).to(dev)
        ref = px.resident_ref_codes(genome, dev)
        q_t, t_t, qlen, tlen = px.unpack_q2(buf, ref, Q, T)
        with sw16(None):
            k = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
        p = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
        valid = sw_cuda.valid_cells(qlen, tlen, Q, T)  # (B, Q, T), the forward's layout
        e_f = max_abs_err(torch, list(zip(k[:3], p[:3])) + [(torch.where(valid, k[3], 0), p[3])])
        # both epilogues against the plain walk and pack
        pt = tb_cuda.sw_traceback_plain(k[3], *k[:3])
        pp = tb_cuda.pack_rle_output(pt[0], pt[1], *k[:3], pt[2])
        kt = tb_cuda.sw_traceback(k[3], *k[:3])
        kp = tb_cuda.sw_traceback_packed(k[3], *k[:3])
        e_t = max_abs_err(torch, list(zip(kt, pt)) + [(kp, pp)])
        with sw16(None):
            fused = px.extend_batch_packed_resident_q2(buf, ref, Q, T, sw, bcap)
            # the main path's input: the forward's q2 loader against the
            # codes loader on unpack_q2's batch, and the one native enqueue
            # against the chain of calls
            k2 = sw_cuda.sw_forward_q2(buf, ref, Q, T, sw)
            staged = px.q2_staging(Q, B)
            staged[...] = buf.cpu().numpy()
            staged_out = px.extend_q2_enqueue(staged, ref, Q, T, sw)
            torch.cuda.current_stream(dev).synchronize()
        e_q2 = max_abs_err(torch, list(zip(k2[:3], k[:3])) + [
            (torch.where(valid, k2[3], 0), torch.where(valid, k[3], 0))])
        same_enqueue = bool((staged_out == fused.cpu().numpy()).all())
        say(f"bucket ({Q}, {T}) B={B}: q2 forward against unpack_q2 + forward max_abs_err "
            f"{e_q2}, one native enqueue byte-equal to the chain of calls {same_enqueue}")
        check(e_q2 == 0 and same_enqueue, f"the q2 forward or the native enqueue differs at "
              f"({Q}, {T})")
        runs_op, runs_len, meta = tb_cuda.sw_traceback_plain(p[3], *p[:3])
        plain = px._pack_rle_output(runs_op, runs_len, *p[:3], meta)
        # the int16 configuration: against its plain int16 version and
        # against the int32 kernel, byte for byte
        with sw16("1"):
            check(sw_cuda.pick_dtype(Q, T, sw) == torch.int16, f"({Q}, {T}) not int16 under RSB_SW16")
            k16 = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
        p16 = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, torch.int16)
        e_16 = max_abs_err(torch, list(zip(k16[:3], p16[:3])) + list(zip(k16[:3], k[:3])) + [
            (torch.where(valid, k16[3], 0), p16[3]), (torch.where(valid, k16[3], 0),
                                                      torch.where(valid, k[3], 0))])
        torch.cuda.synchronize()
        same = torch.equal(fused, plain)
        fields = px.unpack_output(fused.cpu().numpy())
        n_overflow, n_aligned = int((fields[2] == 0xFFFF).sum()), int((fields[3] > 0).sum())
        R, smem = forward_geometry(Q, T)
        say(f"bucket ({Q}, {T}) B={B}: forward (R = {R} rows per lane, {smem} B shared memory "
            f"per 4-warp block) max_abs_err {e_f}, traceback (both epilogues) max_abs_err {e_t}, "
            f"fused output byte-equal {same}, int16 forward against plain int16 and int32 kernel "
            f"max_abs_err {e_16}, {n_aligned} pairs aligned, {n_overflow} over 32 runs")
        # the cross-pair ILP forward: against its plain version and the
        # production int32 kernel, dirs (B, Q, T) on valid cells
        e_s = 0
        k_valid = torch.where(valid, k[3], 0)
        for split in sw_cuda.SPLITS:
            ks = sw_cuda.sw_forward_split(q_t, t_t, qlen, tlen, sw, split)
            ps = sw_cuda.sw_forward_split_plain(q_t, t_t, qlen, tlen, sw, split)
            ks_valid = torch.where(valid, ks[3], 0)
            e_s = max(e_s, max_abs_err(torch, list(zip(ks[:3], ps[:3])) + list(zip(ks[:3], k[:3]))
                                       + [(ks_valid, ps[3]), (ks_valid, k_valid)]))
        say(f"bucket ({Q}, {T}) B={B}: split forward (2 and 4 pairs a warp) against its "
            f"plain version and the production kernel max_abs_err {e_s}")
        check(e_f == 0 and e_t == 0 and same and e_16 == 0 and e_s == 0,
              f"kernel and plain version disagree at ({Q}, {T})")
        check(n_overflow > 0 and n_aligned > B // 2, f"degenerate test batch at ({Q}, {T})")
        err["sw_forward"] = max(err["sw_forward"], e_f)
        err["sw_traceback"] = max(err["sw_traceback"], e_t)
        err["sw_forward_i16"] = max(err["sw_forward_i16"], e_16)
        err["sw_forward_split"] = max(err["sw_forward_split"], e_s)
        if (Q, T) == (512, 2048):  # the widest bucket: the longest walks
            walk_stats(torch, card, f"({Q}, {T})", k[3], *k[:3], pt, B)
        if i == 0:  # the tight, high-volume bucket
            bounds.update(dict.fromkeys(("sw_forward", "sw_forward_i16", "sw_forward_split"),
                                        forward_bound(q_t, t_t, qlen, tlen)))
            bounds["sw_traceback"] = traceback_bound(*k[:3], pt[2])
            with sw16(None):
                times["sw_forward"] = (
                    device_ms(torch, lambda: sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw), 20),
                    time_ms(torch, lambda: sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw), 3))
            with sw16("1"):
                times["sw_forward_i16"] = (
                    device_ms(torch, lambda: sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw), 20),
                    time_ms(torch, lambda: sw_cuda.sw_forward_plain(
                        q_t, t_t, qlen, tlen, sw, torch.int16), 3))
            times["sw_traceback"] = (
                walk_stats(torch, card, f"({Q}, {T})", k[3], *k[:3], pt, B),
                time_ms(torch, lambda: tb_cuda.sw_traceback_packed_plain(k[3], *k[:3]), 3))
            split_ms = {split: device_ms(torch, lambda: sw_cuda.sw_forward_split(
                q_t, t_t, qlen, tlen, sw, split), 20) for split in sw_cuda.SPLITS}
            times["sw_forward_split"] = (split_ms[2], time_ms(
                torch, lambda: sw_cuda.sw_forward_split_plain(q_t, t_t, qlen, tlen, sw, 2), 3))
            say(f"sw_forward_split at ({Q}, {T}) B={B}: 4 pairs a warp {split_ms[4]:.4f} ms "
                f"({split_ms[4] * 1e3 / B:.4f} us/pair); split2 / production "
                f"{split_ms[2] / times['sw_forward'][0]:.3f}, split4 / production "
                f"{split_ms[4] / times['sw_forward'][0]:.3f} [{card}]")
            tb_floor = empty_ms(torch, (B + 3) // 4, 128)
            say(f"empty kernel at the traceback's grid ({(B + 3) // 4} blocks x 128 threads): "
                f"{tb_floor:.4f} ms on the card [{card}]")
            def fused_call():
                return px.extend_batch_packed_resident_q2(buf, ref, Q, T, sw, bcap)

            def enqueue_call():
                px.extend_q2_enqueue(staged, ref, Q, T, sw)

            with sw16(None):
                fused_ms = (time_ms(torch, fused_call, 20), device_ms(torch, fused_call, 20))
                enqueue_ms = (time_ms(torch, enqueue_call, 20), device_ms(torch, enqueue_call, 20))
                q2_ms = device_ms(torch, lambda: sw_cuda.sw_forward_q2(buf, ref, Q, T, sw), 20)
                unpack_ms = device_ms(torch, lambda: px.unpack_q2(buf, ref, Q, T), 20)
            regs = {name: v for name, v in entries.items()
                    if re.search(r"sw_forward_warp_kernelIiLi5E.*Q2In", name)}
            check(len(regs) == 1, f"no ptxas line of the int32 q2 forward at R = 5: {regs}")
            (q2_regs, q2_spill), = regs.values()
            for name, (ms, plain_ms) in times.items():
                say(f"{name} at ({Q}, {T}) B={B}: kernel {ms:.4f} ms on the card "
                    f"({ms * 1e3 / B:.4f} us/pair), "
                    f"plain {plain_ms:.4f} ms ({plain_ms * 1e3 / B:.4f} us/pair), bound "
                    f"{bounds[name][0]:.6f} ms ({bounds[name][1]}) [{card}]")
            say(f"fused extend (unpack + forward + packed traceback) at ({Q}, {T}) B={B}: "
                f"{fused_ms[0]:.4f} ms a call host-paced ({fused_ms[0] * 1e3 / B:.4f} us/pair), "
                f"{fused_ms[1]:.4f} ms on the card [{card}]")
            say(f"sw_forward q2 loader (row 1q) at ({Q}, {T}) B={B}: {q2_ms:.4f} ms on the card "
                f"against unpack_q2 {unpack_ms:.4f} + forward {times['sw_forward'][0]:.4f} = "
                f"{unpack_ms + times['sw_forward'][0]:.4f} ms; R = {R}, {q2_regs} registers, "
                f"{smem} B shared memory a 4-warp block, {q2_spill} bytes spilled; bound "
                f"{bounds['sw_forward'][0]:.6f} ms [{card}]")
            say(f"one native enqueue (upload + q2 forward + packed traceback + copy back) at "
                f"({Q}, {T}) B={B}: {enqueue_ms[0]:.4f} ms a call host-paced, {enqueue_ms[1]:.4f} "
                f"ms on the card [{card}]")
    with sw16("1"):
        wide = sw_cuda.pick_dtype(512, 2048, sw_cuda.SwParams(100, 8, 12, 1))
    check(wide == torch.int32, f"SwParams(100, 8, 12, 1) at (512, 2048) picked {wide}")
    say("span bound: SwParams(100, 8, 12, 1) at (512, 2048) stays int32 under RSB_SW16=1")

    for seed in range(3):
        a = torch.from_numpy(probe.probe_input(seed)).to(dev)
        got = probe.int16_probe(a)
        e_p = max_abs_err(torch, [(got, probe.int16_probe_plain(a))])
        check(e_p == 0, f"int16 probe kernel disagrees with its plain version (seed {seed})")
        err["int16_probe"] = max(err["int16_probe"], e_p)
    times["int16_probe"] = (device_ms(torch, lambda: probe.int16_probe(a), 100),
                            time_ms(torch, lambda: probe.int16_probe_plain(a), 100))
    bounds["int16_probe"] = bound(2 * a.numel() * a.element_size(),
                                  OPS_PER_PROBE_ELEM * a.numel())
    probe_floor = empty_ms(torch, (a.numel() + 255) // 256, 256)
    say(f"int16 probe {tuple(a.shape)}: kernel equals plain (max_abs_err 0) on 3 seeded tiles; "
        f"kernel {times['int16_probe'][0]:.4f} ms, plain {times['int16_probe'][1]:.4f} ms, "
        f"bound {bounds['int16_probe'][0]:.6f} ms; an empty kernel at its grid "
        f"({(a.numel() + 255) // 256} blocks x 256 threads) {probe_floor:.4f} ms, at one block "
        f"of 32 threads {empty_ms(torch, 1, 32):.4f} ms [{card}]")
    return err, times, bounds


def ilp(torch, card):
    """The ILP probe harness on its own path: counts set to 0 before it."""
    phase("ILP: cross-pair ILP probe (tools/ilp_probe.py)")
    from rabbitsalign_tpu_torch.ops import sw_cuda
    from rabbitsalign_tpu_torch.tools import ilp_probe

    with sw16(None):
        sw_cuda.launches_split = 0
        inputs = tuple(x.to(DEVICE) for x in ilp_probe.probe_inputs())
        medians = ilp_probe.run(card, inputs)
        torch.cuda.synchronize()
        launches = sw_cuda.launches_split
        # each split against its plain version on the harness's inputs
        # (check_exact held it to production), tolerance 0
        q_t, t_t, qlen, tlen = inputs
        valid = sw_cuda.valid_cells(qlen, tlen, q_t.shape[0], t_t.shape[0])
        for split in sw_cuda.SPLITS:
            ks = sw_cuda.sw_forward_split(*inputs, ilp_probe.PARAMS, split)
            ps = sw_cuda.sw_forward_split_plain(*inputs, ilp_probe.PARAMS, split)
            e = max_abs_err(torch, list(zip(ks[:3], ps[:3])) + [(torch.where(valid, ks[3], 0),
                                                                 ps[3])])
            check(e == 0, f"ILP probe inputs: split {split} differs from its plain version ({e})")
        say(f"ILP probe inputs: split2 and split4 equal to their plain versions (max_abs_err 0) "
            f"and to production [{card}]")
        # the same three on the card, queued behind a sleep kernel (the
        # paired slopes are paced by the host's chained launches), in turns
        on_card = {tag: [] for tag in ilp_probe.VARIANTS}
        for tag in ilp_probe.VARIANTS + ilp_probe.VARIANTS[::-1]:
            fn = ilp_probe._variant(tag)
            on_card[tag].append(device_ms(torch, lambda: fn(*inputs), 20))
    check(launches > 0, "the ILP probe never launched the split kernel")
    say(f"ILP probe: sw_forward_split launched {launches} times; split2 / production "
        f"{medians['split2'] / medians['production']:.3f}, split4 / production "
        f"{medians['split4'] / medians['production']:.3f} [{card}]")
    prod = sum(on_card["production"]) / 2
    say("ILP probe inputs on the card (ms, in turns there and back): " + ", ".join(
        f"{tag} {a:.4f} / {b:.4f}" for tag, (a, b) in on_card.items())
        + f"; split2 / production {sum(on_card['split2']) / 2 / prod:.3f}, split4 / production "
        f"{sum(on_card['split4']) / 2 / prod:.3f} [{card}]")
    return launches


def map_run(main, tag, argv):
    """One CLI call; returns (sha256 of its SAM without @PG, reads,
    mapping-loop reads/s, whole-call reads/s, wall s, phase times, index
    read s, the device seeding or sharded lookups line or "")."""
    out = WORK / f"{tag}.sam"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = main([*argv, "-o", str(out)])
    wall = time.perf_counter() - t0
    text = log.getvalue()
    check(rc == 0, f"{tag}: rabbitsalign-tpu-torch exited {rc}:\n{text[-3000:]}")
    m = re.search(r"Mapped (\d+) reads in ([0-9.]+) s \((\d+) reads/s\)", text)
    check(m is not None, f"{tag}: no 'Mapped' line in the log")
    n_reads = int(m.group(1))
    phases = re.search(r"Phase times: (.*)", text)
    index_s = re.search(r"Total time reading index: ([0-9.]+) s", text)
    dseed = re.search(r"(?:Device seeding|Sharded lookups): (.*)", text)
    digest = hashlib.sha256()
    with open(out, "rb") as f:
        for line in f:
            if not line.startswith(b"@PG"):
                digest.update(line)
    out.unlink()
    return digest.hexdigest(), n_reads, int(m.group(3)), n_reads / wall, wall, \
        phases.group(1) if phases else "", float(index_s.group(1)) if index_s else None, \
        dseed.group(1) if dseed else ""


def device_busy(trace_dir: Path):
    """(busy share, span ms, kernel names, device events) of the one
    torch.profiler trace in trace_dir: the union of the card's kernel,
    memcpy and memset intervals over the span of all timed events."""
    traces = list(trace_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"expected one trace in {trace_dir}, found {traces}")
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    check(events, f"{traces[0]} holds no timed events")
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, -float("inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    return busy / (t1 - t0), (t1 - t0) / 1e3, names, len(dev)


def make_data():
    """The 40 Mbp genome, SE reads and PE pairs as FASTA/FASTQ under WORK,
    and its index, built with -i. Returns (reference path, {"SE": argv,
    "PE": argv})."""
    phase("data: genome, reads and index")
    import bench
    from rabbitsalign_tpu_torch.cli import main

    t0 = time.perf_counter()
    genome = bench.np_genome(GENOME_BP, 4321)
    ref = WORK / "genome40m.fa"
    with open(ref, "wb") as f:
        f.write(b">chr21sim\n")
        f.write(b"\n".join(genome[i:i + 80] for i in range(0, len(genome), 80)) + b"\n")
    se = WORK / "se.fq"
    bench.write_fastq(se, bench.simulate_se(genome, N_SE_READS), "r")
    r1, r2 = bench.simulate_pe(genome, N_PE_PAIRS)
    pe = (WORK / "r1.fq", WORK / "r2.fq")
    bench.write_fastq(pe[0], r1, "p")
    bench.write_fastq(pe[1], r2, "q")
    del genome, r1, r2
    say(f"data: {GENOME_BP} bp genome, {N_SE_READS} SE reads, {N_PE_PAIRS} PE pairs "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        rc = main([str(ref), "-i", "-r", "150", "-t", "8"])
    check(rc == 0, f"index build failed:\n{log.getvalue()[-3000:]}")
    say(f"index built with -i in {time.perf_counter() - t0:.1f} s")
    sidecar = Path(f"{ref}.r150.sti.cols")
    check((sidecar / "header.json").is_file(), f"-i wrote no sidecar at {sidecar}")
    say(f"-i wrote the mmap sidecar {sidecar.relative_to(ROOT)}")
    return ref, {"SE": [str(ref), str(se)], "PE": [str(ref), str(pe[0]), str(pe[1])]}


def flush_l2(torch):
    """A write over 128 MB, more than the 50 MB L2, between timed calls."""
    buf = torch.empty(32 << 20, dtype=torch.int32, device=DEVICE)
    return lambda: buf.fill_(1)


def lookup_probes(torch, h, size: int, start: int, buckets, bits: int, q):
    """The reads of the hash array that find_runs_kernel makes for the
    keys q, replayed with torch ops in its order: (search steps of the
    bucket-bounded lower bound, equality reads, gallop and binary probes
    for a found key's run end), each summed over the keys."""
    from rabbitsalign_tpu_torch.ops.seed_device import flip, lsr

    m = h.numel()
    fh, fq = flip(h), flip(q)
    top = lsr(q, 64 - bits)
    lo = (buckets[top] - start).clamp(min=0)
    hi0 = hi = (buckets[top + 1] - start).clamp(max=size)
    steps = 0
    while bool((act := lo < hi).any()):
        steps += int(act.sum())
        mid = lo + ((hi - lo) >> 1)
        less = fh[mid.clamp(max=m - 1)] < fq
        lo, hi = torch.where(act & less, mid + 1, lo), torch.where(act & ~less, mid, hi)
    eq = lo < hi0
    found = eq & (h[lo.clamp(max=m - 1)] == q)
    first = lo.clamp(max=m - 1)
    a, b, gallop, step = first + 1, torch.full_like(first, m), 0, 1
    open_ = found.clone()
    while bool((act := open_ & (first + step < m)).any()):
        gallop += int(act.sum())
        ne = act & (h[(first + step).clamp(max=m - 1)] != q)
        b = torch.where(ne, first + step, b)
        a = torch.where(act & ~ne, first + step + 1, a)
        open_ = act & ~ne
        step <<= 1
    while bool((act := found & (a < b)).any()):
        gallop += int(act.sum())
        mid = a + ((b - a) >> 1)
        same = h[mid.clamp(max=m - 1)] == q
        a, b = torch.where(act & same, mid + 1, a), torch.where(act & ~same, mid, b)
    return steps, int(eq.sum()), gallop


def find_sectors(torch, h, buckets, bits: int, q) -> int:
    """The distinct 32-byte sectors that index_find reads for the queries
    q, replayed with torch ops and summed over the queries: each query's
    bucket pair (8-byte rows of the table), the binary search over its
    bucket (csrc/bucket_search.cuh) and the equality read. Allocations
    start at 256-byte boundaries, so row i lies in sector i // 4."""
    from rabbitsalign_tpu_torch.ops.seed_device import flip, lsr

    n = h.numel()
    fh, fq = flip(h), flip(q)
    top = lsr(q, 64 - bits)
    lo, hi = buckets[top], buckets[top + 1].clamp(max=n)
    a, b = lo.clone(), hi.clone()
    cols = []  # sector ids of the hash array, -1 for no read
    while bool((act := a < b).any()):
        mid = a + ((b - a) >> 1)
        cols.append(torch.where(act, mid // 4, -1))
        less = fh[mid.clamp(max=n - 1)] < fq
        a, b = torch.where(act & less, mid + 1, a), torch.where(act & ~less, mid, b)
    cols.append(torch.where(a < hi, a // 4, -1))  # the equality read
    ids = torch.stack(cols, 1).sort(dim=1).values
    fresh = torch.cat([ids[:, :1] >= 0, (ids[:, 1:] != ids[:, :-1]) & (ids[:, 1:] >= 0)], 1)
    pair = 1 + (top // 4 != (top + 1) // 4).long()
    return int(fresh.sum()) + int(pair.sum())


def load_index(ref):
    """The 40 Mbp index that make_data built, read from its .sti."""
    from rabbitsalign_tpu_torch.index.params import IndexParameters
    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.io.fasta import References

    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(References.from_fasta(str(ref)), params)
    index.read(f"{ref}{params.filename_extension()}")
    return index


def seed_kernels(torch, card, index, se_fastq):
    """Phase Seed: the seeding and lookup kernels against their plain
    versions on the card, times, bounds and the library call."""
    phase("Seed: the seeding kernels against their plain versions")
    import numpy as np

    from rabbitsalign_tpu_torch.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu_torch.ops import seed_cuda, seed_device
    from tests.torch_seed_cases import SEED_L, code_batch, edge_reads

    dev = torch.device(DEVICE)
    params = index.parameters
    hashes, buckets = (torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)
                       for a in (index.hashes, index.randstrobe_start_indices))
    bits = index.bits
    with open(se_fastq, "rb") as f:
        chunk = [line.rstrip(b"\n") for i, line in zip(range(4 * 10_000), f) if i % 4 == 1]
    edge = edge_reads(3)
    codes, lens = (torch.from_numpy(a).to(dev) for a in code_batch(chunk + edge))
    sp, rp = params.syncmer, params.randstrobe
    M = SEED_L
    args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, M)
    B = codes.shape[0]
    buf, total = seed_cuda.seed_randstrobes(codes, lens, *args)
    want, want_total = seed_device.seed_strobes_plain(codes, lens, *args)
    got_v, want_v = (seed_device.strobe_views(x, B, total) for x in (buf, want))
    torch.cuda.synchronize()
    err = {"seed_randstrobes": max_abs_err(torch, zip(got_v[:6], want_v[:6]))
           + abs(total - want_total)}
    check(total == want_total and all(g.dtype == w.dtype and torch.equal(g, w)
                                      for g, w in zip(got_v[:6], want_v[:6])),
          f"seed_randstrobes disagrees with its plain version (totals {total} and "
          f"{want_total}, max_abs_err {err['seed_randstrobes']})")
    # nothing past the chunk's strobes is written in the worst-case buffer
    filled = seed_cuda.seed_buffer(B, M, dev).fill_(0xA5)
    seed_cuda.launch_seed_randstrobes(codes, lens, *args, filled)
    end = seed_device.strobe_bytes(B, total)
    untouched = bool((filled[end:seed_cuda._scratch_at(B, M)] == 0xA5).all())
    check(untouched and all(torch.equal(g, w) for g, w in zip(
        seed_device.strobe_views(filled, B, total)[:6], want_v[:6])),
        "seed_randstrobes wrote past the chunk's strobes, or differs in a filled buffer")
    counts = got_v[0]
    n_edge, n_chunk = len(edge), len(chunk)
    edge_counts = counts[-n_edge:].cpu().tolist()
    check((counts[-5:] == -1).any() and edge_counts[:2] == [0, 0] and edge_counts[4] == -1,
          f"edge reads: counts {edge_counts}")
    chunk_strobes_n = int(counts[:n_chunk].clamp(min=0).sum())
    say(f"seed_randstrobes on {n_chunk} reads + {n_edge} edge reads x {SEED_L}: equal to its "
        f"plain version (max_abs_err 0 over counts, offsets, hashes, starts, ends, is_rev and "
        f"the total); {chunk_strobes_n} strobes in the chunk ({chunk_strobes_n / n_chunk:.1f} a "
        f"read), {int((counts[:n_chunk] == -1).sum())} tie rows; nothing written past the "
        f"{end} bytes of the strobes in the {filled.numel()}-byte buffer; edge counts "
        f"{edge_counts}")

    chunk_q = got_v[2][:chunk_strobes_n]  # the chunk's strobes, as seed_and_find looks them up
    misses = torch.from_numpy(np.random.RandomState(1).randint(
        -(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64)).to(dev)
    queries = torch.cat([got_v[2], hashes[:1], misses])
    pos = seed_cuda.index_find(hashes, buckets, bits, queries)
    pos_plain = seed_device.index_find_device(hashes, buckets, bits, queries)
    err["index_find"] = max_abs_err(torch, [(pos, pos_plain)])
    check(torch.equal(pos, pos_plain), f"index_find disagrees with its plain version "
                                       f"(max_abs_err {err['index_find']})")
    check(int(pos[total]) == -1, "the smallest hash was found (bucket-table quirk)")
    seed_cuda.index_find(hashes, buckets, bits, got_v[2], out=got_v[6])
    check(torch.equal(got_v[6], pos[:total]), "index_find into the seeding buffer differs")
    same = StrobemerIndex(index.references, params, bits)
    same.hashes = np.full(9, index.hashes[1000], np.uint64)
    same._build_buckets()
    s_h, s_b = (torch.from_numpy(a.view(np.int64).copy()).to(dev)
                for a in (same.hashes, same.randstrobe_start_indices))
    s_q = torch.cat([s_h[:1], queries[:100]])
    s_pos = seed_cuda.index_find(s_h, s_b, bits, s_q)
    check(bool((s_pos == -1).all()) and torch.equal(
        s_pos, seed_device.index_find_device(s_h, s_b, bits, s_q)),
        "index_find on an all-equal index")
    hits = int((pos[:total] >= 0).sum())
    say(f"index_find on {queries.numel()} queries against the {GENOME_BP} bp index "
        f"({len(index)} hashes, bits {bits}): equal to its plain version, {hits} of {total} "
        f"strobes found, the smallest hash -1, an all-equal index finds nothing")

    # times: the seeding kernel (a memset and two launches) at the chunk's shape,
    # on the card and, with its one sync for the total, host-paced; the
    # lookup on the chunk's strobes, an L2 flush before each call (timed
    # alone and subtracted) and back to back
    seed_ms = device_ms(torch, lambda: seed_cuda.launch_seed_randstrobes(codes, lens, *args,
                                                                         filled), 20)
    seed_host = time_ms(torch, lambda: seed_cuda.seed_randstrobes(codes, lens, *args), 20)
    times = {"seed_randstrobes": (seed_ms, time_ms(
        torch, lambda: seed_device.seed_strobes_plain(codes, lens, *args), 3))}
    flush = flush_l2(torch)
    flush_ms = device_ms(torch, flush, 20)

    def flushed(fn):
        return lambda: (flush(), fn())

    seed_cold = device_ms(torch, flushed(lambda: seed_cuda.launch_seed_randstrobes(
        codes, lens, *args, filled)), 20) - flush_ms
    find_ms = device_ms(torch, flushed(lambda: seed_cuda.index_find(
        hashes, buckets, bits, chunk_q)), 20) - flush_ms
    warm_ms = device_ms(torch, lambda: seed_cuda.index_find(hashes, buckets, bits, chunk_q), 20)
    times["index_find"] = (find_ms, time_ms(
        torch, lambda: seed_device.index_find_device(hashes, buckets, bits, chunk_q), 3))
    fh, fq = seed_device.flip(hashes), seed_device.flip(chunk_q)
    library = {"index_find": device_ms(torch, flushed(lambda: torch.searchsorted(fh, fq)), 20)
               - flush_ms, "seed_randstrobes": None}
    library_warm = device_ms(torch, lambda: torch.searchsorted(fh, fq), 20)

    # bounds for this run's inputs: the s-mers of the reads with a k-mer
    # window, the syncmers of the rows that link strobes, and each
    # strobe's strobe-2 candidates (d in [w_min, w_max] with m + d < n)
    n_len = lens.clamp(min=0, max=SEED_L)
    n_smer = int((n_len - sp.s + 1).where(n_len >= sp.k, 0).sum())
    n_out = (counts.clamp(min=0) // 2).long()
    n_sync = int((n_out + rp.w_min).where(n_out > 0, 0).sum())
    span = rp.w_max - rp.w_min + 1  # slot m of n_out has min(span, n_out - m)
    a = n_out.clamp(max=span)
    n_cand = 2 * int((a * (a + 1) // 2 + (n_out - a) * span).sum())
    seed_bytes = B * SEED_L + 4 * B + 17 * total + 12 * B
    tops = seed_device.lsr(chunk_q, 64 - bits)
    width = (buckets[tops + 1] - buckets[tops]).clamp(min=0).double()
    steps = int(torch.ceil(torch.log2(width + 1)).sum())
    nq = chunk_q.numel()
    seed_ops = OPS_PER_SMER * n_smer + OPS_PER_SYNCMER * n_sync + OPS_PER_LINK_CAND * n_cand
    bounds = {"seed_randstrobes": bound(seed_bytes, seed_ops),
              "index_find": bound(32 * nq + 8 * (steps + nq), OPS_PER_FIND_STEP * steps)}
    for name, (ms, plain_ms) in times.items():
        lib = library[name]
        say(f"{name}: kernel {ms:.4f} ms on the card, plain {plain_ms:.4f} ms, bound "
            f"{bounds[name][0]:.6f} ms ({bounds[name][1]}), one PyTorch call "
            f"{'none' if lib is None else f'{lib:.4f} ms'} [{card}]")
    say(f"seed_randstrobes at {B} x {SEED_L} (counts, offsets and {total} compacted strobes): "
        f"{seed_ms:.4f} ms on the card back to back, {seed_cold:.4f} ms after an L2 flush, "
        f"{seed_host:.4f} ms host-paced with the read of the total; "
        f"{seed_ms * 1e6 / B:.2f} ns a read; {seed_bytes / 1e6:.2f} MB read and written, "
        f"{seed_ops / 1e6:.1f} M operations ({n_smer} s-mers, {n_sync} syncmers, {n_cand} "
        f"candidates) [{card}]")
    say(f"index_find of {nq} queries ({steps / max(nq, 1):.2f} search steps a query): "
        f"{find_ms:.4f} ms after an L2 flush (flush alone {flush_ms:.4f} ms), {warm_ms:.4f} ms "
        f"back to back; torch.searchsorted over the sign-flipped hashes "
        f"{library['index_find']:.4f} ms after a flush, {library_warm:.4f} ms back to back [{card}]")
    # the sectors the lookup moves: each query's distinct 32-byte sectors,
    # beside its 8 bytes in and 8 out (coalesced); and an empty kernel at a
    # grid of a thread a query and at the kernel's (two queries a thread)
    n_sec = find_sectors(torch, hashes, buckets, bits, chunk_q)
    floor_ms = (32 * n_sec + 16 * nq) / HBM_BYTES_PER_S * 1e3
    grids = ((nq + 255) // 256, (nq + 511) // 512)
    say(f"index_find sectors of {nq} queries: {n_sec} 32-byte sectors ({n_sec / nq:.3f} a "
        f"query), a floor of {floor_ms:.6f} ms (bound {bounds['index_find'][0]:.6f} ms) [{card}]")
    say(f"empty kernel of {grids[0]} x 256 threads {empty_ms(torch, grids[0], 256):.4f} ms, of "
        f"{grids[1]} x 256 {empty_ms(torch, grids[1], 256):.4f} ms on the card [{card}]")
    return err, times, bounds, library


def chunk_strobes(index, se_fastq):
    """The strobe hashes of the first SE chunk (10 000 reads), seeded on
    the host by the engine as --shard-index seeds them."""
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.map.common import MappingParameters
    from rabbitsalign_tpu_torch.native.engine import NativeEngine, NativeReader

    engine = NativeEngine(index, index.parameters, index.references, AlignmentParameters(),
                          MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff))
    reader = NativeReader(str(se_fastq), chunk_size=10_000, producer=False)
    try:
        _, fx, n_pairs, n_singles = next(iter(reader))
        try:
            h, total = engine.fx_seed_only(fx)
            hashes = engine.fx_seed_copy(h, 2 * n_pairs + n_singles, total)[2]
        finally:
            reader.free_chunk(fx)
    finally:
        reader.close()
        engine.close()
    return hashes, 2 * n_pairs + n_singles


def long_runs(torch, card) -> int:
    """The lookup on an index of runs of 1, 31, 32, 33 and more than the
    cap rows (tests/torch_gather_lanes.py `RunsIndex`) at 1 and 4 shards
    of the card against the CPU: every lookup of ShardedIndex at caps 2,
    40 and the filter cutoff, and the wrappers' gather at cap 40 dense, at
    the pod's `ends - width` and compacted with keys skipped. Returns the
    largest error (0)."""
    import numpy as np

    from rabbitsalign_tpu_torch.ops import shard_cuda, shard_find
    from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh
    from tests.torch_gather_lanes import RunsIndex

    stub = RunsIndex(40)
    heads = np.unique(stub.hashes)
    keys = np.concatenate([heads, heads + np.uint64(1), np.array([0, 2**64 - 1], np.uint64)])
    err = 0
    for n_shards in (1, 4):
        on_card, on_cpu = (ShardedIndex(make_mesh(n_shards, d), stub) for d in (DEVICE, "cpu"))
        for cap in (2, 40, stub.filter_cutoff):
            for name in ("find_runs", "find_runs_routed", "find_runs_compact"):
                got, want = (getattr(si, name)(keys, cap) for si in (on_card, on_cpu))
                for key in want:
                    check(got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]),
                          f"{name} at cap {cap}, {n_shards} shards, runs over 32 rows: {key} "
                          f"differs from the CPU")
    h, p, k = on_card._shards[0]
    q = torch.from_numpy(keys.view(np.int64)).to(DEVICE)
    gpos, count = shard_cuda.find_runs(h, on_card.shard_sizes[0], 0, on_card._buckets,
                                       on_card.bits, q)
    width = count.clamp(max=40)
    ends = torch.cumsum(width, 0)
    for dst in (None, ends - width, torch.where(q % 3 == 0, -1, ends - width)):
        rows = q.numel() * 40 if dst is None else int(ends[-1])
        outs = [torch.zeros(rows, dtype=torch.int32, device=DEVICE) for _ in range(4)]
        shard_cuda.gather_runs(p, k, gpos, count, 0, 40, dst, *outs[:2])
        shard_find.gather_runs_plain(p, k, gpos, count, 0, 40, dst, *outs[2:])
        err = max(err, max_abs_err(torch, [(outs[0], outs[2]), (outs[1], outs[3])]))
    check(err == 0, f"gather_runs on runs over 32 rows disagrees with its plain version ({err})")
    lens = np.unique(stub.hashes, return_counts=True)[1]
    say(f"find_runs and gather_runs on runs of {sorted(set(lens.tolist()))} rows at 1 and 4 "
        f"shards of the card: every lookup at caps 2, 40 and {stub.filter_cutoff}, and the "
        f"gather at cap 40 dense, at the pod's offsets and with keys skipped, equal to the "
        f"plain versions [{card}]")
    return err


def shard_kernels(torch, card, index, se_fastq):
    """Phase Shard: the run lookup of --shard-index against its plain
    versions on the card, at 1 and 4 shards of the one card; times, bound
    and the library call at 1 shard, the main path's shape."""
    phase("Shard: the --shard-index run lookup against its plain versions")
    import numpy as np

    from rabbitsalign_tpu_torch.ops import seed_device, shard_cuda, shard_find
    from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh

    dev = torch.device(DEVICE)
    strobes, n_reads = chunk_strobes(index, se_fastq)
    misses = np.random.RandomState(2).randint(0, 2**63, 4096, dtype=np.int64).astype(np.uint64)
    keys = np.concatenate([strobes, misses, np.array([2**64 - 1, index.hashes[0]], np.uint64)])
    fc = index.filter_cutoff
    err = 0
    for n_shards in (1, 4):
        t0 = time.perf_counter()
        on_card = ShardedIndex(make_mesh(n_shards, DEVICE), index)
        build_s = time.perf_counter() - t0
        on_cpu = ShardedIndex(make_mesh(n_shards, "cpu"), index)
        for name, call in (("find_runs", lambda si: si.find_runs(keys, fc)),
                           ("find_runs_routed cap 2", lambda si: si.find_runs_routed(keys, 2)),
                           ("find_runs_compact", lambda si: si.find_runs_compact(keys))):
            got, want = call(on_card), call(on_cpu)
            e = max(int(np.abs(got[k].astype(np.int64) - want[k].astype(np.int64)).max())
                    if want[k].size else 0 for k in want)
            check(all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                      for k in want), f"{name} at {n_shards} shards: the card's lookup differs "
                                      f"from the plain version on the CPU (max_abs_err {e})")
            err = max(err, e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = on_card.find_runs_compact(keys)
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        on_card._route(keys)
        route_ms = (time.perf_counter() - t0) * 1e3
        walked = int((res["run_off"] >= 0).sum())
        say(f"{n_shards} shard(s) of the card ({on_card.shard_sizes} randstrobes, built and "
            f"uploaded in {build_s:.2f} s): find_runs, find_runs_routed (cap 2) and "
            f"find_runs_compact equal to the plain versions on the CPU over {keys.size} keys "
            f"({strobes.size} strobes of {n_reads} reads, 4096 misses, the sentinel hash, the "
            f"smallest hash); {int((res['count'] > 0).sum())} found, "
            f"{int(res['filtered'].sum())} filtered, {walked} walked with "
            f"{res['run_positions'].size} run rows; find_runs_compact {wall_ms:.2f} ms a call "
            f"host-paced (routing, upload, two launches a shard, the cumsum's sync, four copies "
            f"back), of which the host's routing {route_ms:.2f} ms [{card}]")
    check(res["count"][-2] == 0 and res["count"][-1] == 0,
          "the sentinel key or the smallest hash (bucket quirk) was found")

    # the kernels alone on the one-shard index (the main path's shape on
    # one card): the wrappers against the plain versions on the same tensors
    single = ShardedIndex(make_mesh(1, DEVICE), index)
    h, p, k = single._shards[0]
    size, buckets, bits = single.shard_sizes[0], single._buckets, single.bits
    def layout(count, cap):
        """dst and rows of the compacting gather: the walked keys (found,
        count <= cap) back to back."""
        walk = (count > 0) & (count <= cap)
        width = torch.where(walk, count, 0)
        return torch.where(walk, torch.cumsum(width, 0) - width, -1), int(width.sum())

    q = torch.from_numpy(keys.view(np.int64)).to(dev)
    gpos, count = shard_cuda.find_runs(h, size, 0, buckets, bits, q)
    plain = shard_find.find_runs_plain(h, size, 0, buckets, bits, q)
    dst, n_rows = layout(count, fc)
    outs = [torch.zeros(max(n_rows, 1), dtype=torch.int32, device=dev) for _ in range(4)]
    shard_cuda.gather_runs(p, k, gpos, count, 0, fc, dst, *outs[:2])
    shard_find.gather_runs_plain(p, k, plain[0], plain[1], 0, fc, dst, *outs[2:])
    torch.cuda.synchronize()
    err = max(err, max_abs_err(torch, [(gpos, plain[0]), (count, plain[1]), (outs[0], outs[2]),
                                       (outs[1], outs[3])]))
    check(err == 0, f"find_runs disagrees with its plain version (max_abs_err {err})")
    err = max(err, long_runs(torch, card))
    nq = q.numel()

    def kernel():
        g, c = shard_cuda.find_runs(h, size, 0, buckets, bits, q)
        shard_cuda.gather_runs(p, k, g, c, 0, fc, dst, *outs[:2])

    def plain_call():
        g, c = shard_find.find_runs_plain(h, size, 0, buckets, bits, q)
        shard_find.gather_runs_plain(p, k, g, c, 0, fc, dst, *outs[2:])

    def search():
        return shard_cuda.find_runs(h, size, 0, buckets, bits, q)

    def gather():
        shard_cuda.gather_runs(p, k, gpos, count, 0, fc, dst, *outs[:2])

    flush = flush_l2(torch)
    flush_ms = device_ms(torch, flush, 20)
    ms = device_ms(torch, lambda: (flush(), kernel()), 20) - flush_ms
    search_cold = device_ms(torch, lambda: (flush(), search()), 20) - flush_ms
    gather_cold = device_ms(torch, lambda: (flush(), gather()), 20) - flush_ms
    warm_ms = device_ms(torch, kernel, 20)
    search_ms = device_ms(torch, search, 20)
    gather_ms = device_ms(torch, gather, 20)
    # the same search over two half-shard buckets (a one-bit table, split
    # where the hashes' top bit turns on): the depth of a search over the
    # whole shard, beside the index's bits-bit table in the same call
    halves = torch.tensor([0, int((h[:size] >= 0).sum()), size], device=dev)
    wide_ms = device_ms(torch, lambda: shard_cuda.find_runs(h, size, 0, halves, 1, q), 20)
    plain_ms = time_ms(torch, plain_call, 3)
    fh, fq = seed_device.flip(h), seed_device.flip(q)
    lib_ms = device_ms(torch, lambda: (flush(), torch.searchsorted(fh, fq)), 20) - flush_ms
    lib_warm = device_ms(torch, lambda: torch.searchsorted(fh, fq), 20)
    steps, eq_reads, gallop = lookup_probes(torch, h, size, 0, buckets, bits, q)
    probes = steps + eq_reads + gallop
    b = bound(SHARD_KEY_BYTES * nq + 8 * probes + SHARD_ROW_BYTES * n_rows,
              OPS_PER_FIND_STEP * steps)
    # every random read moves a whole 32-byte sector: the bucket pair, each
    # search step, the equality read and each gallop probe, beside the
    # key's coalesced 8 bytes in and 16 out
    sectors = nq + probes
    sector_ms = (32 * sectors + 24 * nq) / HBM_BYTES_PER_S * 1e3
    say(f"find_runs (search + compacting gather) of {nq} keys on one shard of {h.numel()} "
        f"entries: kernel {ms:.4f} ms on the card after an L2 flush (flush alone "
        f"{flush_ms:.4f} ms), {warm_ms:.4f} ms back to back; after a flush the search "
        f"{search_cold:.4f} ms and the gather {gather_cold:.4f} ms, back to back {search_ms:.4f} "
        f"and {gather_ms:.4f} ms (the search over two half-shard buckets {wide_ms:.4f} ms); plain "
        f"{plain_ms:.4f} ms; bound {b[0]:.6f} ms ({b[1]}; {n_rows} run rows, {probes} probes: "
        f"{steps} search steps, {steps / nq:.2f} a key, {eq_reads} equality reads, "
        f"{gallop} gallop probes); the search's 32-byte sectors {sectors}, a floor of "
        f"{sector_ms:.6f} ms; torch.searchsorted over the sign-flipped hashes {lib_ms:.4f} ms "
        f"after a flush, {lib_warm:.4f} ms back to back [{card}]")
    return {"find_runs": err}, {"find_runs": (ms, plain_ms)}, {"find_runs": b}, \
        {"find_runs": lib_ms}


def walk_compact_err(torch, chain_cuda, front_device, args, n: int, total: int, err: dict,
                     name: str):
    """`walk_hits_compact` on `args` against its plain version, tolerance
    0, the error folded into err["walk_hits"]; returns the kernel's views
    (hits, n_hits, total, good, overflow)."""
    got = front_device.walk_views(chain_cuda.walk_hits_compact(*args), n, total)
    want = front_device.walk_views(front_device.walk_hits_compact_plain(*args), n, total)
    e = max_abs_err(torch, zip(got, want))
    err["walk_hits"] = max(err["walk_hits"], e)
    check(e == 0, f"walk_hits_compact disagrees with its plain version on {name} "
                  f"(max_abs_err {e})")
    return got


def chain_kernels(torch, card, index, se_fastq):
    """Phase Chain: the device NAM front end (kernels syncmers_scan,
    merge_hits and walk_hits, with the seeding and lookup kernels) on the
    first SE chunk and the 40 Mbp index: its path driven with the counts
    set to 0, the entry points against the host find_nams and the engine,
    each kernel against its plain version, times, bounds."""
    phase("Chain: the device NAM front end against its plain versions and the host")
    import numpy as np

    from rabbitsalign_tpu_torch.chain.nams import find_nams
    from rabbitsalign_tpu_torch.chain.native_nams import find_nams_chunk
    from rabbitsalign_tpu_torch.ops import chain_cuda, chain_device, front_device, seed_cuda
    from rabbitsalign_tpu_torch.ops import seed_device as sd
    from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query
    from tests.torch_chain_cases import (long_runs_world, merge_edge_streams, mixed_runs, nam_key,
                                         stream_tensors, world_strobes)
    from tests.torch_seed_cases import SEED_L, code_batch, tie_reads

    dev = torch.device(DEVICE)
    params = index.parameters
    sp, rp = params.syncmer, params.randstrobe
    fc, bits, k = index.filter_cutoff, index.bits, sp.k
    with open(se_fastq, "rb") as f:
        chunk = [line.rstrip(b"\n") for i, line in zip(range(4 * 10_000), f) if i % 4 == 1]
    n = len(chunk)
    t0 = time.perf_counter()
    dev_index = front_device.upload_index_split(index, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    codes, lens = (torch.from_numpy(a).to(dev) for a in code_batch(chunk))
    seed_args = (sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q, rp.max_dist, SEED_L)

    # the slice's path, its counts set to 0 before and read after: the
    # composed front end on the chunk, the device chain on 200 of its
    # reads, and the exact scan seeder on the chunk
    counters = {"seed_randstrobes": lambda: seed_cuda.launches_seed,
                "index_find": lambda: seed_cuda.launches_find,
                "syncmers_scan": lambda: seed_cuda.launches_syncmers,
                "walk_hits": lambda: chain_cuda.launches_walk,
                "merge_hits": lambda: chain_cuda.launches_merge}
    seed_cuda.launches_seed = seed_cuda.launches_find = seed_cuda.launches_syncmers = 0
    chain_cuda.launches_walk = chain_cuda.launches_merge = 0
    stats = {}
    t0 = time.perf_counter()
    composed = front_device.find_nams_composed_batch(chunk, dev_index, params, fc, stats=stats)
    cold_s = time.perf_counter() - t0
    qrs = [randstrobes_query(r, params) for r in chunk[:200]]
    chained = [chain_device.find_nams_device_chain(q, index, device=dev) for q in qrs]
    exact = sd.randstrobes_query_device(codes, lens.clamp(min=0), *seed_args)
    torch.cuda.synchronize()
    launches = {name: read() for name, read in counters.items()}
    say(f"Chain path (find_nams_composed_batch on {n} reads, find_nams_device_chain on 200, "
        f"randstrobes_query_device on {n}): kernel launches {launches}")
    check(all(launches.values()), f"Chain: a kernel of the path never launched: {launches}")

    # the composed batch against the engine's find_nams (rescue level 0)
    t0 = time.perf_counter()
    host_nams, host_nonrep, _ = find_nams_chunk(chunk, index, params, 0, 0)
    chunk_s = time.perf_counter() - t0
    flagged = [i for i, c in enumerate(composed) if c is None]
    n_nams = 0
    for i, c in enumerate(composed):
        if c is None:
            continue
        got = [nam_key(x, np.float32) for x in c[1]]
        check(np.float32(c[0]) == host_nonrep[i] and
              got == [nam_key(x, np.float32) for x in host_nams[i]],
              f"read {i}: find_nams_composed_batch differs from find_nams_chunk")
        n_nams += len(got)
    reasons = {key: stats[key] for key in ("long", "tie", "hit_overflow", "merge_overflow")}
    say(f"find_nams_composed_batch equals find_nams_chunk (rescue level 0) on {n - len(flagged)} "
        f"of {n} reads: the nonrepetitive fraction, {n_nams} NAMs' ids, query and ref starts and "
        f"ends, n_hits, ref_id, strand, score as float32; {len(flagged)} reads flagged for the "
        f"host path ({reasons})")
    check(len(flagged) <= 0.02 * n, f"{len(flagged)} of {n} reads flagged, more than 2%")
    for q, (frac, nams) in zip(qrs, chained):
        want = find_nams(q, index)
        check(frac == want[0] and [nam_key(x) for x in nams] == [nam_key(x) for x in want[1]],
              "find_nams_device_chain differs from chain/nams.find_nams")
    say(f"find_nams_device_chain on the card equals chain/nams.find_nams on 200 reads "
        f"({sum(len(x[1]) for x in chained)} NAMs)")

    # the exact seeder against the vectorised one and, on its tie rows, the host
    err = {}
    pos, hsh, cnt = seed_cuda.syncmers_scan(codes, lens, sp.k, sp.s, sp.t_syncmer, SEED_L)
    plain = sd.syncmers_scan_plain(codes, lens, sp.k, sp.s, sp.t_syncmer, SEED_L)
    err["syncmers_scan"] = max_abs_err(torch, zip((pos, hsh, cnt), plain))
    check(err["syncmers_scan"] == 0, f"syncmers_scan disagrees with its plain version "
                                     f"(max_abs_err {err['syncmers_scan']})")
    vec = sd.randstrobes_query_vec(codes, lens.clamp(min=0), *seed_args)
    h, st, en, _, nf, nr = exact
    M = SEED_L
    slot = torch.arange(2 * M, device=dev)[None, :]
    valid = torch.where(slot < M, slot < nf[:, None], slot - M < nr[:, None])
    tie = vec[5]
    same = ((nf == vec[3]) & (nr == vec[4]) & ~(valid & ((h != vec[0]) | (st != vec[1]) |
                                                         (en != vec[2]))).any(1))
    check(bool((same | tie).all()), "randstrobes_query_device differs from randstrobes_query_vec "
                                    "on a row it does not flag")
    h, st, en, nf, nr = (x.cpu().numpy() for x in (h, st, en, nf, nr))
    ties = tie.nonzero().squeeze(1).cpu().tolist()
    for i in ties:
        host = randstrobes_query(chunk[i], params)
        rows = list(range(nf[i])) + list(range(M, M + nr[i]))
        check(h[i, rows].view(np.uint64).tolist() == host.hash.tolist() and
              st[i, rows].tolist() == host.start.tolist() and
              en[i, rows].tolist() == host.end.tolist(),
              f"randstrobes_query_device differs from the host on tie row {i}")
    say(f"syncmers_scan on {n} x {SEED_L}: equal to its plain version ({int(cnt.sum())} "
        f"syncmers); randstrobes_query_device equals randstrobes_query_vec on the "
        f"{n - len(ties)} rows it does not flag and the host randstrobes_query on its "
        f"{len(ties)} tie rows")

    # the walk and the merge on the chunk's own strobes and streams
    buf, total = seed_cuda.seed_randstrobes(codes, lens, *seed_args)
    views = sd.strobe_views(buf, n, total)
    seed_cuda.index_find(dev_index[7], dev_index[4], bits, views[2], out=views[6])
    khi, klo = sd.hash_planes(views[2])
    gary = sd.index_find_device_gary(dev_index[0], dev_index[1], dev_index[4], bits, khi, klo,
                                     dev_index[6])
    check(torch.equal(gary, views[6]), "index_find_device_gary differs from the index_find kernel")
    planes = (dev_index[7], dev_index[2], dev_index[3])
    walk_maxh = 192  # the composed batch's hits a read
    walk_args = (*views[:7], *planes, k, fc, walk_maxh, fc)
    walked = chain_cuda.walk_hits(*walk_args)
    err["walk_hits"] = max_abs_err(torch, zip(walked, front_device.walk_hits_plain(*walk_args)))
    check(err["walk_hits"] == 0, f"walk_hits disagrees with its plain version "
                                 f"(max_abs_err {err['walk_hits']})")
    # the main path's layout: each read's room its strobe count at its
    # strobe offset, every run that passes the filter walked whole
    compact_args = (*views[:7], *planes, k, fc, fc)
    compact = walk_compact_err(torch, chain_cuda, front_device, compact_args, n, total, err,
                               "the chunk")
    front = front_device.front_hits(chunk, dev_index, params, fc)
    streams, _ = front_device.hit_streams(front)
    batch = chain_device.stream_batch(streams, dev)
    err["merge_hits"] = 0
    n_ovf = {}
    edge = [x.to(dev) for x in stream_tensors(merge_edge_streams())]
    for name, args, caps in (("chunk", batch, (32, 4, 200)),
                             ("boundary", edge, (200, 129, 65, 33, 32, 8, 3))):
        for cap in caps:
            got = chain_cuda.merge_hits(*args, k, cap)
            want = chain_device.merge_hits_plain(*args, k, cap)
            e = max_abs_err(torch, zip(got, want))
            err["merge_hits"] = max(err["merge_hits"], e)
            check(e == 0, f"merge_hits at cap {cap} disagrees with its plain version on the "
                          f"{name} streams (max_abs_err {e})")
            check(int(got[2].view(torch.uint8).max()) <= 1, "merge_hits wrote a flag past 1")
            n_ovf[name, cap] = int(got[2].sum())
    check(n_ovf["chunk", 4] > 0 and n_ovf["boundary", 129] > 0,
          "merge_hits at cap 4 on the chunk or 129 on the boundary streams: no overflow")
    emitted = chain_cuda.merge_hits(*batch, k, 32)
    n_hits_all, n_emit = batch[0].shape[0], int(emitted[1].sum())
    say(f"index_find_device_gary equals the index_find kernel on the chunk's {total} strobes; "
        f"walk_hits equals its plain version ({int(walked[1].sum())} kept hits, "
        f"{int(walked[2].sum())} found, {int(walked[3].sum())} walked strobes), and "
        f"walk_hits_compact its plain version ({int(compact[1].sum())} kept hits, "
        f"{int(compact[4].sum())} reads overflow); merge_hits "
        f"equals its plain version on all {len(streams)} streams of the chunk ({n_hits_all} "
        f"hits, {n_emit} NAMs) at cap 32 ({n_ovf['chunk', 32]} streams overflow), 4 "
        f"({n_ovf['chunk', 4]}) and 200 ({n_ovf['chunk', 200]}), and on the "
        f"{edge[2].numel() - 1} boundary streams (tables of 8 and 32 slots full and one past, "
        f"sweeps and flushes on the lane and the warp, empty streams, 150 and 140 NAMs open at "
        f"once) at caps 200, 129, 65, 33, 32, 8 and 3 (overflowing "
        f"{[n_ovf['boundary', c] for c in (200, 129, 65, 33, 32, 8, 3)]}) [{card}]")

    # the scan on a tie-heavy batch of as many reads (tandem repeats of 1-29
    # bp units, homopolymers, N runs: the replay at work), the walk on the
    # 80-copy repeat's runs and on runs of 1 to 80 rows mixed in a round
    ties = tie_reads(n, seed=13)
    tcodes, tlens = (torch.from_numpy(a).to(dev) for a in code_batch(ties))
    tie_scan = lambda: seed_cuda.syncmers_scan(tcodes, tlens, sp.k, sp.s, sp.t_syncmer, SEED_L)
    tie_got = tie_scan()
    tie_err = max_abs_err(torch, zip(tie_got, sd.syncmers_scan_plain(tcodes, tlens, sp.k, sp.s,
                                                                     sp.t_syncmer, SEED_L)))
    err["syncmers_scan"] = max(err["syncmers_scan"], tie_err)
    check(tie_err == 0, f"syncmers_scan disagrees with its plain version on the tie-heavy batch "
                        f"(max_abs_err {tie_err})")
    rep_index, rep_params, rep_reads = long_runs_world()
    rep_views, rep_planes = world_strobes(rep_index, rep_params, rep_reads)
    rep_args = tuple(x.to(dev) for x in (*rep_views, *rep_planes))
    mixed_args = tuple(x.to(dev) for x in mixed_runs()[0])
    rfc = rep_index.filter_cutoff
    walks = []
    for name, args, kk, cutoff, maxh, cap in (
            ("repeat", rep_args, rep_params.syncmer.k, rfc, walk_maxh, rfc),
            ("repeat", rep_args, rep_params.syncmer.k, 1000, 4000, 100),
            ("mixed", mixed_args, 20, 1000, 4000, 100), ("mixed", mixed_args, 20, 33, 60, 33)):
        got = chain_cuda.walk_hits(*args, kk, cutoff, maxh, cap)
        e = max_abs_err(torch, zip(got, front_device.walk_hits_plain(*args, kk, cutoff, maxh,
                                                                     cap)))
        err["walk_hits"] = max(err["walk_hits"], e)
        check(e == 0, f"walk_hits disagrees with its plain version on the {name} runs at cutoff "
                      f"{cutoff}, maxh {maxh}, cap {cap} (max_abs_err {e})")
        walks.append(f"{name} cutoff {cutoff} maxh {maxh} cap {cap}: {int(got[1].sum())} hits, "
                     f"{int(got[4].sum())} reads overflow")
    rep_compact = walk_compact_err(torch, chain_cuda, front_device,
                                   (*rep_args, rep_params.syncmer.k, rfc, rfc),
                                   rep_args[0].numel(), rep_args[2].numel(), err, "the repeat")
    check(bool(rep_compact[4].any()), "walk_hits_compact: no read of the 80-copy repeat "
                                      "overflows its room")
    walks.append(f"repeat compact cutoff {rfc} cap {rfc}: {int(rep_compact[1].sum())} hits, "
                 f"{int(rep_compact[4].sum())} reads overflow")
    say(f"syncmers_scan equals its plain version on {n} tie-heavy reads "
        f"({int(tie_got[2].sum())} syncmers); walk_hits equals its plain version on the 80-copy "
        f"repeat's {len(rep_reads)} reads and the mixed runs' {mixed_args[0].numel()} reads "
        f"({'; '.join(walks)}) [{card}]")

    # times: each kernel after an L2 flush, its plain version host-paced
    flush = flush_l2(torch)
    flush_ms = device_ms(torch, flush, 20)
    tie_ms = device_ms(torch, lambda: (flush(), tie_scan()), 10) - flush_ms
    # the walk's dense output alone: one torch zero_ of its (N, maxh, 6) hits
    slots = torch.empty((n, walk_maxh, 6), dtype=torch.int32, device=dev)
    slots_ms = device_ms(torch, lambda: (flush(), slots.zero_()), 10) - flush_ms
    del slots
    # one merge_hits launch of find_nams_device_chain: one read's streams
    one_read = []
    for q in qrs:
        _, per_ref = chain_device._collect_hits(q, index)
        parts = [chain_device.ordered_stream(per_ref[rc])[:2] for rc in (0, 1)]
        parts = [x for x in parts if x[0]]
        if parts:
            one_read.append(chain_device.stream_batch(parts, dev))
        if len(one_read) == 20:
            break
    read_cold = sorted(device_ms(torch, lambda: (flush(), chain_cuda.merge_hits(*b, k, 32)), 5)
                       - flush_ms for b in one_read)
    read_warm = sorted(device_ms(torch, lambda: chain_cuda.merge_hits(*b, k, 32), 20)
                       for b in one_read)
    read_hits = sorted(int(b[0].shape[0]) for b in one_read)
    read_floor = empty_ms(torch, 1, 128)
    say(f"merge_hits, one launch of find_nams_device_chain (one read's streams, {len(one_read)} "
        f"reads of {read_hits[0]}-{read_hits[-1]} hits, median {read_hits[len(read_hits) // 2]}): "
        f"median {read_cold[len(read_cold) // 2]:.4f} ms after an L2 flush (range "
        f"{read_cold[0]:.4f}-{read_cold[-1]:.4f}), median {read_warm[len(read_warm) // 2]:.4f} "
        f"ms back to back, one kernel a call; an empty launch of one block {read_floor:.4f} ms "
        f"[{card}]")
    scan = lambda: seed_cuda.syncmers_scan(codes, lens, sp.k, sp.s, sp.t_syncmer, SEED_L)
    merge = lambda: chain_cuda.merge_hits(*batch, k, 32)
    walk = lambda: chain_cuda.walk_hits_compact(*compact_args)
    dense_ms = device_ms(torch, lambda: (flush(), chain_cuda.walk_hits(*walk_args)), 10) - flush_ms
    times = {}
    for name, fn, plain_fn, reps in (
            ("syncmers_scan", scan, lambda: sd.syncmers_scan_plain(
                codes, lens, sp.k, sp.s, sp.t_syncmer, SEED_L), 1),
            ("merge_hits", merge, lambda: chain_device.merge_hits_plain(*batch, k, 32), 1),
            ("walk_hits", walk, lambda: front_device.walk_hits_compact_plain(*compact_args), 3)):
        cold = device_ms(torch, lambda: (flush(), fn()), 10) - flush_ms
        times[name] = (cold, time_ms(torch, plain_fn, reps))
        say(f"{name}: {cold:.4f} ms on the card after an L2 flush, {device_ms(torch, fn, 10):.4f} "
            f"ms back to back [{card}]")

    merge_report(torch, card, batch, one_read, k)

    # bounds for this run's inputs
    n_len = lens.clamp(min=0)
    n_smer = int((n_len - sp.s + 1).clamp(min=0).sum())
    scan_bytes = n * SEED_L + 4 * n + 12 * n * SEED_L + 4 * n
    found = views[6] >= 0
    p = views[6].clamp(min=0)
    nidx = dev_index[7].numel()
    filtered = found & (p + fc < nidx) & (dev_index[7][(p + fc).clamp(max=nidx - 1)] == views[2])
    walk_mask = found & ~filtered
    run_end = torch.searchsorted(sd.flip(dev_index[7]), sd.flip(views[2]), right=True)
    rows = int(torch.where(walk_mask, (run_end - p).clamp(max=fc), 0).sum())
    kept = int(compact[1].sum())
    bounds = {"syncmers_scan": bound(scan_bytes, OPS_PER_SMER * n_smer),
              "merge_hits": bound(MERGE_HIT_BYTES * n_hits_all + MERGE_NAM_BYTES * n_emit,
                                  OPS_PER_MERGE_HIT * n_hits_all),
              "walk_hits": bound((WALK_STROBE_BYTES + WALK_SLOT_BYTES) * total
                                 + WALK_ROW_BYTES * rows + WALK_READ_BYTES * n, 0)}
    dense_bound = bound(WALK_STROBE_BYTES * total + WALK_ROW_BYTES * rows
                        + WALK_SLOT_BYTES * n * walk_maxh + WALK_READ_BYTES * n, 0)
    for name, (ms, plain_ms) in times.items():
        say(f"{name}: kernel {ms:.4f} ms on the card after an L2 flush, plain {plain_ms:.4f} ms, "
            f"bound {bounds[name][0]:.6f} ms ({bounds[name][1]}), one PyTorch call none, "
            f"launches {launches[name]} [{card}]")
    say(f"bounds' inputs: {n_smer} s-mers; {n_hits_all} hits and {n_emit} NAMs in "
        f"{len(streams)} streams (the merge's bound ignores that a stream is a serial chain); "
        f"{total} strobes, {rows} walked run rows, {kept} kept hits in {total} slots (the compact "
        f"layout, one a strobe)")
    say(f"walk_hits in the dense layout ({n} x {walk_maxh} slots, the composed batch's): "
        f"{dense_ms:.4f} ms after an L2 flush, bound {dense_bound[0]:.6f} ms; its {n} x "
        f"{walk_maxh} x 6 int32 hits written by one torch zero_: {slots_ms:.4f} ms after an L2 "
        f"flush; the compact layout's walk {times['walk_hits'][0]:.4f} ms [{card}]")
    say(f"syncmers_scan on the tie-heavy batch (the replay's worst case): {tie_ms:.4f} ms after "
        f"an L2 flush, {tie_ms / bounds['syncmers_scan'][0]:.1f}x the chunk's bound, "
        f"{tie_ms / times['syncmers_scan'][0]:.2f}x the chunk's time [{card}]")

    # the composed batch's wall time a chunk, host-paced, in four parts
    warm = []
    for _ in range(3):
        st_ = {}
        t0 = time.perf_counter()
        front_device.find_nams_composed_batch(chunk, dev_index, params, fc, stats=st_)
        warm.append((time.perf_counter() - t0, st_))
    best, parts = min(warm, key=lambda x: x[0])
    t0 = time.perf_counter()
    find_nams_chunk(chunk, index, params, 0, 0)
    chunk_warm = time.perf_counter() - t0
    say(f"find_nams_composed_batch on {n} reads, host-paced: {best * 1e3:.1f} ms (best of 3; "
        f"first call {cold_s * 1e3:.1f} ms): device front end with its copy back "
        f"{parts['front'] * 1e3:.1f} ms, host ordering {parts['order'] * 1e3:.1f} ms, merge with "
        f"its copy back {parts['merge'] * 1e3:.1f} ms, attribution {parts['attribute'] * 1e3:.1f} "
        f"ms; find_nams_chunk (the engine) on the same chunk {chunk_warm * 1e3:.1f} ms (first "
        f"call {chunk_s * 1e3:.1f} ms); the index uploaded in {upload_s:.2f} s [{card}]")
    return err, times, bounds, {name: None for name in times}, launches


def cuda_kernels_of(torch, fn):
    """The names of the work on the card that one call of fn queues
    (torch.profiler): kernels, copies and fills. A capture with no event
    at all, which CUPTI now and then delivers for a short session, is
    taken again, up to three calls."""
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        work = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if work:
            break
    return work


def merge_report(torch, card, batch, one_reads, k):
    """merge_hits on the chunk's streams: their lengths, the share of
    streams and hits each path takes, the slowest warp's work, a lane's
    time a hit and the chain floor, and one kernel a call."""
    import numpy as np

    from rabbitsalign_tpu_torch.ops import chain_cuda
    from tests.torch_chain_cases import lane_chain_streams, stream_tensors

    cap, L = 32, 32  # the callers' cap; the slots of a lane's table (csrc/merge_hits.cu)
    H = (batch[2][1:] - batch[2][:-1]).cpu().numpy()
    S, n_hits = len(H), int(H.sum())
    edges = [0, 1, 2, 5, 9, 17, 33, 65, 129]
    hist = {f"{lo}-{hi - 1}" if hi - lo > 1 else str(lo): int(((H >= lo) & (H < hi)).sum())
            for lo, hi in zip(edges, edges[1:])}
    hist[f"{edges[-1]}+"] = int((H >= edges[-1]).sum())
    say(f"merge_hits on the chunk: {S} streams, {n_hits} hits; stream lengths: max {H.max()}, "
        f"p99 {np.percentile(H, 99):.0f}, median {np.median(H):.0f}, mean {H.mean():.2f}; "
        f"histogram {hist}")
    W = (S + 31) // 32
    pad = lambda a: np.concatenate([a, np.zeros(W * 32 - S, a.dtype)]).reshape(W, 32)
    # a stream goes to the warp when it holds L NAMs open and one more opens
    # below the cap, exactly where it overflows at cap L
    on_warp = chain_cuda.merge_hits(*batch, k, L)[2].cpu().numpy() & (np.minimum(cap, H) > L)
    say(f"merge_hits paths at cap {cap}, a lane table of {L} slots: lane "
        f"{int((~on_warp).sum())} streams ({(~on_warp).mean():.4f}) and "
        f"{int(H[~on_warp].sum())} hits ({H[~on_warp].sum() / n_hits:.4f}); warp "
        f"{int(on_warp.sum())} streams ({on_warp.mean():.4f}) and "
        f"{int(H[on_warp].sum())} hits ({H[on_warp].sum() / n_hits:.4f})")
    lane_chain = pad(H).max(1)  # the longest stream a lane starts (at most its hits)
    warp_chain = pad(np.where(on_warp, H, 0)).sum(1)  # the warp's streams, in turn
    w = int(np.argmax(lane_chain + warp_chain))
    say(f"  slowest warp {w} of {W}: its lanes' longest stream {lane_chain[w]} hits, then "
        f"{int(pad(on_warp.astype(np.int64))[w].sum())} streams of {warp_chain[w]} hits on the "
        f"warp; over all warps the longest lane chain {lane_chain.max()} hits, the most warp "
        f"hits {warp_chain.max()}")
    # a lane's time a hit: one stream of 4096 hits, one lane
    per_hit = {}
    for name, stream in zip(("collinear (one NAM extended)", "open and swept"),
                            lane_chain_streams(4096)):
        args = [x.to(DEVICE) for x in stream_tensors([stream])]
        check(not bool(chain_cuda.merge_hits(*args, k, L)[2].any()),
              f"the lane's stream needs more than {L} slots")
        ms = device_ms(torch, lambda: chain_cuda.merge_hits(*args, k, cap), 10)
        per_hit[name] = ms / 4096
        say(f"merge_hits, one lane on one stream of 4096 hits, {name}: {ms:.4f} ms back to back, "
            f"{ms / 4096 * 1e6:.1f} ns a hit [{card}]")
    floor = int(H.max()) * per_hit["collinear (one NAM extended)"]
    say(f"merge_hits chain floor: the chunk's longest stream, {H.max()} hits, x a lane's "
        f"{per_hit['collinear (one NAM extended)'] * 1e6:.1f} ns a hit = {floor:.6f} ms [{card}]")
    # one kernel a call, nothing else on the card
    for name, args in (("the chunk", batch), ("one read", one_reads[0])):
        work = cuda_kernels_of(torch, lambda: chain_cuda.merge_hits(*args, k, cap))
        check(len(work) == 1 and "merge_hits_kernel" in work[0],
              f"merge_hits on {name} queued {work} on the card, not one merge kernel")
    say(f"merge_hits queues one kernel a call and nothing else on the card (torch.profiler), on "
        f"the chunk and on one read")


def main_path(torch, card, reads):
    phase("4: main path")
    from rabbitsalign_tpu_torch.cli import main
    from rabbitsalign_tpu_torch.native import cache_dir
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import int16_probe as probe
    from rabbitsalign_tpu_torch.ops import chain_cuda, seed_cuda, shard_cuda, sw_cuda, tb_cuda

    base = ["--use-index", "--no-progress"]
    trace_dir = WORK / "trace"
    # path -> (RSB_SW16, {SE/PE: extra flags}); the SE runs of the
    # default paths leave -t at its default (3 workers)
    paths = {
        "t1": (None, {"SE": ["-t", "1"], "PE": ["-t", "1"]}),
        "t3": (None, {"SE": [], "PE": ["--deterministic", "-t", "3"]}),
        "t3-sw16": ("1", {"SE": [], "PE": ["--deterministic", "-t", "3"]}),
        "t3-mmap": (None, {"SE": ["--mmap-index"]}),
        "t3-profile": (None, {"SE": ["--profile", str(trace_dir)]}),
        "t1-shard": (None, {"SE": ["-t", "1", "--shard-index"],
                            "PE": ["-t", "1", "--shard-index"]}),
        "t3-shard": (None, {"SE": ["--shard-index"],
                            "PE": ["--deterministic", "-t", "3", "--shard-index"]}),
    }
    host_paths = ("t1", "t3")  # each also run with --no-tpu
    counters = {"sw_forward": lambda: sw_cuda.launches,
                "sw_forward_i16": lambda: sw_cuda.launches_i16,
                "sw_traceback": lambda: tb_cuda.launches,
                "int16_probe": lambda: probe.launches,
                "seed_randstrobes": lambda: seed_cuda.launches_seed,
                "index_find": lambda: seed_cuda.launches_find,
                "walk_hits": lambda: chain_cuda.launches_walk,
                "find_runs": lambda: shard_cuda.launches_find_runs}
    runs, launches, dispatches = {}, {}, {}
    for path, (sw16_value, flags) in paths.items():
        # a cold probe cache, as on a host's first run: the prewarm of the
        # path's first device run launches the probe kernel
        for old in cache_dir().glob("int16_probe_*.json"):
            old.unlink()
        with sw16(sw16_value):
            sw_cuda.launches = sw_cuda.launches_i16 = tb_cuda.launches = 0
            probe.launches = px.calls = 0
            seed_cuda.launches_seed = seed_cuda.launches_find = chain_cuda.launches_walk = 0
            shard_cuda.launches_find_runs = 0
            for name, extra in flags.items():
                runs[path, name] = map_run(main, f"{name}.{path}.cuda",
                                           [*reads[name], *base, *extra, "--device", DEVICE])
            torch.cuda.synchronize()
            launches[path] = {k: read() for k, read in counters.items()}
            dispatches[path] = px.calls
        cached = probe.probe_cache_path(0)
        check(cached.is_file(), f"{path}: no probe result at {cached}")
        say(f"{path}: int16 probe result {cached.read_text().strip()} cached at {cached}")
        if path in host_paths:
            for name, extra in flags.items():
                runs[path, name, "host"] = map_run(main, f"{name}.{path}.host",
                                                   [*reads[name], *base, *extra, "--no-tpu"])
        say(f"{path}: device extend dispatches {dispatches[path]}, kernel launches "
            f"{launches[path]}")
        check(dispatches[path] > 0, f"{path}: no extend batch was dispatched to the device")
        fwd = "sw_forward_i16" if sw16_value else "sw_forward"
        unused = "sw_forward" if sw16_value else "sw_forward_i16"
        check(all(launches[path][k] > 0 for k in (fwd, "sw_traceback", "int16_probe")),
              f"{path}: a kernel of the path never launched: {launches[path]}")
        check(launches[path][unused] == 0, f"{path}: {unused} launched: {launches[path]}")
        seeding = [launches[path][k] for k in ("seed_randstrobes", "index_find")]
        check(not any(seeding) if path in SHARD_PATHS else all(seeding),
              f"{path}: seeding kernel launches {seeding}")
        n_walk = launches[path]["walk_hits"]
        check(n_walk == 0 if path in SHARD_PATHS else n_walk == seeding[0],
              f"{path}: walk_hits launches {n_walk}, once a chunk (seed_randstrobes "
              f"{seeding[0]}) expected, none with --shard-index")
        n_find = launches[path]["find_runs"]
        check(n_find > 0 if path in SHARD_PATHS else n_find == 0,
              f"{path}: find_runs launches {n_find}")
        if path in SHARD_PATHS:
            misses = [runs[path, name][7] for name in flags]
            check(all(line.endswith("feed misses 0") for line in misses),
                  f"{path}: the engine missed run records: {misses}")

    for key, run in runs.items():
        _, n, rate_log, rate_wall, wall, phases, index_s, dseed = run
        say(f"{' '.join(key)}: {n} reads, mapping loop {rate_log} reads/s, whole CLI call "
            f"{rate_wall:.1f} reads/s ({wall:.2f} s), index read {index_s} s [{card}]; {phases}"
            + (f"; device seeding or sharded lookups {dseed}" if dseed else ""))
    same = [(("t1", "SE"), ("t1", "SE", "host")), (("t1", "PE"), ("t1", "PE", "host")),
            (("t3", "SE"), ("t3", "SE", "host")), (("t3", "SE"), ("t1", "SE")),
            (("t3", "PE"), ("t3", "PE", "host")),
            (("t3-sw16", "SE"), ("t3", "SE")), (("t3-sw16", "PE"), ("t3", "PE")),
            (("t3-mmap", "SE"), ("t3", "SE")), (("t3-profile", "SE"), ("t3", "SE")),
            (("t1-shard", "SE"), ("t1", "SE")), (("t1-shard", "PE"), ("t1", "PE")),
            (("t3-shard", "SE"), ("t3", "SE")), (("t3-shard", "PE"), ("t3", "PE"))]
    for a, b in same:
        check(runs[a][0] == runs[b][0],
              f"SAM of {' '.join(a)} differs from {' '.join(b)}")
        say(f"SAM {' '.join(a)} == {' '.join(b)} apart from @PG")
    for name in reads:
        say(f"{name} mapping loop, device: -t 1 {runs['t1', name][2]} reads/s, "
            f"3 workers {runs['t3', name][2]} reads/s, 3 workers int16 "
            f"{runs['t3-sw16', name][2]} reads/s [{card}]")
    for path in SHARD_PATHS:
        plain = path.split("-")[0]
        for name in reads:
            a, b = runs[path, name], runs[plain, name]
            say(f"{name} {path} against {plain}: mapping loop {a[2]} against {b[2]} reads/s; "
                f"{a[5]}; sharded lookups {a[7]} | {plain}: {b[5]}; device seeding {b[7]} "
                f"[{card}]")
    say(f"SE index open, 3 workers: 'Total time reading index' {runs['t3', 'SE'][6]} s from the "
        f".sti, {runs['t3-mmap', 'SE'][6]} s with --mmap-index [{card}]")

    share, span_ms, names, n_dev = device_busy(trace_dir)
    for kernel in ("sw_forward_warp_kernel", "sw_traceback_kernel"):
        check(any(kernel in n for n in names), f"the --profile trace has no {kernel} event: {names}")
    say(f"--profile SE 3 workers: {n_dev} kernel/copy events, both extend kernels present; "
        f"device busy {share:.6f} (idle {1 - share:.6f}) of the {span_ms:.1f} ms traced mapping "
        f"run; mapping loop {runs['t3-profile', 'SE'][2]} reads/s traced against "
        f"{runs['t3', 'SE'][2]} untraced [{card}]")
    return {k: sum(launches[path][k] for path in paths) for k in counters}, runs


MULTI_ENTRIES = 2  # phase Multi: a device list naming the card twice


@contextlib.contextmanager
def local_devices_as(torch, entries):
    """The port sees `entries` as its local devices for --device cuda, as
    on a host with that many cards; the NativePipelines made meanwhile and
    the devices the genome is uploaded to are recorded."""
    from rabbitsalign_tpu_torch.parallel import sharding
    from rabbitsalign_tpu_torch.pipeline import native_pipeline as pnp

    real = sharding.local_devices, pnp.NativePipeline.__init__, pnp.resident_ref_codes
    pipes, uploads = [], []

    def local(device="cuda"):
        return list(entries) if torch.device(device).type == entries[0].type else real[0](device)

    def init(self, *args, **kw):
        real[1](self, *args, **kw)
        pipes.append(self)

    def upload(codes, device):
        uploads.append(str(device))
        return real[2](codes, device)

    sharding.local_devices = pnp.local_devices = local
    pnp.NativePipeline.__init__ = init
    pnp.resident_ref_codes = upload
    try:
        yield pipes, uploads
    finally:
        sharding.local_devices = pnp.local_devices = real[0]
        pnp.NativePipeline.__init__ = real[1]
        pnp.resident_ref_codes = real[2]


def multi(torch, card, reads, runs):
    """Phase Multi: the CLI's 3-worker runs with a local device list of
    two entries of the card. Returns the kernels' launches in it."""
    phase("Multi: the extend round-robin and --shard-index over a device list naming the card "
          "twice")
    from rabbitsalign_tpu_torch.cli import main
    from rabbitsalign_tpu_torch.ops import shard_cuda, sw_cuda, tb_cuda
    from rabbitsalign_tpu_torch.parallel.sharding import local_devices

    cards = local_devices(DEVICE)
    say(f"local_devices({DEVICE!r}) = {[str(d) for d in cards]}, torch.cuda.device_count() = "
        f"{torch.cuda.device_count()} [{card}]")
    if len(cards) == 1:
        say("one card: no copy between cards ran (the extend's uploads and the shards' merge "
            "across cards are held only by the CPU tests and test_torch_cuda.py)")
    entries = [torch.device(DEVICE, 0)] * MULTI_ENTRIES
    base = ["--use-index", "--no-progress", "--device", DEVICE]
    paths = {"multi2": {"SE": [], "PE": ["--deterministic", "-t", "3"]},
             "multi2-shard": {"SE": ["--shard-index"],
                              "PE": ["--deterministic", "-t", "3", "--shard-index"]}}
    totals = {"sw_forward": 0, "sw_traceback": 0, "find_runs": 0}
    for path, flags in paths.items():
        sw_cuda.launches = tb_cuda.launches = shard_cuda.launches_find_runs = 0
        for name, extra in flags.items():
            with local_devices_as(torch, entries) as (pipes, uploads):
                run = map_run(main, f"{name}.{path}.cuda",
                              [*reads[name], *base, *extra])
            key = f"{path} {name}"
            check(uploads == [str(entries[0])], f"{key}: genome uploads {uploads}, one a "
                  f"distinct card expected")
            split = [p.dispatched for p in pipes]
            check(len(pipes) == 3 and all(
                d == [(sum(d) + 1) // 2, sum(d) // 2] for d in split) and all(
                sum(col) > 0 for col in zip(*split)),
                f"{key}: the workers' dispatches an entry {split} are not split in turn over "
                f"both entries")
            check(all(list(p.streams) == entries[:1] for p in pipes) or entries[0].type != "cuda",
                  f"{key}: streams a card {[list(p.streams) for p in pipes]}")
            if "--shard-index" in extra:
                si = pipes[0].sharded_index
                check(si.devices == entries and all(p.sharded_index is si for p in pipes),
                      f"{key}: shards on {si.devices}, one shard an entry expected")
                check(run[7].endswith("feed misses 0"), f"{key}: the engine missed run records: "
                      f"{run[7]}")
            plain = "t3-shard" if "--shard-index" in extra else "t3"
            check(run[0] == runs[plain, name][0], f"SAM of {key} differs from {plain} {name}")
            say(f"SAM {key} == {plain} {name} apart from @PG; {run[1]} reads, mapping loop "
                f"{run[2]} reads/s against {runs[plain, name][2]} ({plain}); dispatches an entry "
                f"by worker {split}; genome uploads {uploads}"
                + (f"; sharded lookups {run[7]}" if run[7] else "") + f" [{card}]")
        torch.cuda.synchronize()
        launched = {"sw_forward": sw_cuda.launches, "sw_traceback": tb_cuda.launches,
                    "find_runs": shard_cuda.launches_find_runs}
        say(f"{path}: kernel launches {launched}")
        check(launched["sw_forward"] > 0 and launched["sw_traceback"] > 0,
              f"{path}: the extend kernels never launched: {launched}")
        check((launched["find_runs"] > 0) == path.endswith("-shard"),
              f"{path}: find_runs launches {launched['find_runs']}")
        for k, v in launched.items():
            totals[k] += v
    return totals


def free_ports(n: int):
    """n ports the OS has free now (bound to port 0, then released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


def pod_run(tag, argv, pod_index: bool):
    """One two-host pod: both CLI processes started together, waited for,
    and killed if still running when this returns. Returns (sha256 of the
    merged SAM without @PG, wall s, [one dict a host: reads, mapping-loop
    reads/s, pod total, kernel launches, merge s or None, pod index
    traffic or None, the sharded-lookups line or ""])."""
    from rabbitsalign_tpu_torch.native import cache_dir

    for old in cache_dir().glob("int16_probe_*.json"):
        old.unlink()  # a cold probe cache, as a host's first run
    out = WORK / f"{tag}.sam"
    coord, *peers = free_ports(3)
    extra = ["--pod-index-peers", ",".join(f"127.0.0.1:{p}" for p in peers)] if pod_index else []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmds = [[sys.executable, "-m", "rabbitsalign_tpu_torch.cli", *argv, "-t", "1", "-v", "-o",
             str(out), "--num-nodes", "2", "--node-id", str(node), "--coordinator",
             f"127.0.0.1:{coord}", *extra] for node in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    try:
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    hosts = []
    for node, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"{tag} host {node} exited {p.returncode}:\n{err[-3000:]}")
        m = re.search(r"Mapped (\d+) reads in ([0-9.]+) s \((\d+) reads/s\)", err)
        total = re.search(rf"Host {node}/2: mapped \d+ reads in [0-9.]+ s; pod total (\d+)", err)
        launches = re.search(rf"Host {node}/2 kernel launches: (.*)", err)
        check(m and total and launches, f"{tag} host {node}: no mapping, pod or launch line:\n"
              f"{err[-3000:]}")
        merge = re.search(r"Merged 2 output shards into .* in ([0-9.]+) s", err)
        traffic = re.search(rf"Pod index traffic of host {node}: (.*)", err)
        lookups = re.search(r"Sharded lookups: (.*)", err)
        hosts.append({"reads": int(m.group(1)), "rate": int(m.group(3)),
                      "pod_total": int(total.group(1)),
                      "launches": json.loads(launches.group(1)),
                      "merge_s": float(merge.group(1)) if merge else None,
                      "traffic": json.loads(traffic.group(1)) if traffic else None,
                      "lookups": lookups.group(1) if lookups else ""})
    check(hosts[0]["merge_s"] is not None and hosts[1]["merge_s"] is None,
          f"{tag}: node 0 alone must merge")
    digest = hashlib.sha256()
    with open(out, "rb") as f:
        for line in f:
            if not line.startswith(b"@PG"):
                digest.update(line)
    for part in WORK.glob(f"{tag}.sam*"):
        part.unlink()
    return digest.hexdigest(), wall, hosts


def pod(card, reads, runs):
    """Phase Pod: three pods of two processes on the card, and the PE one
    with --no-tpu as its reference. Returns the device pods' kernel
    launches, summed over their processes."""
    phase("Pod: two hosts of a --num-nodes 2 pod on the one card")
    base = ["--use-index", "--no-progress", "--device", DEVICE]
    specs = {("pod2", "SE"): (reads["SE"], False, []),
             ("pod2-shard", "SE"): (reads["SE"], True, []),
             ("pod2", "PE"): (reads["PE"], False, []),
             ("pod2", "PE", "host"): (reads["PE"], False, ["--no-tpu"])}
    pods = {}
    for key, (files, pod_index, extra) in specs.items():
        pods[key] = pod_run(".".join(key), [*files, *base, *extra], pod_index)
        digest, wall, hosts = pods[key]
        n_total = N_SE_READS if key[1] == "SE" else 2 * N_PE_PAIRS
        check(sum(h["reads"] for h in hosts) == n_total and
              all(h["pod_total"] == n_total for h in hosts),
              f"{' '.join(key)}: the hosts mapped {[h['reads'] for h in hosts]} of {n_total}")
        for node, h in enumerate(hosts):
            n = h["launches"]
            if key[-1] == "host":
                check(n["extend_dispatches"] == 0, f"{' '.join(key)} host {node}: {n}")
            else:
                check(n["extend_dispatches"] > 0 and n["sw_forward"] > 0 and
                      n["sw_traceback"] > 0,
                      f"{' '.join(key)} host {node}: the extend kernels never launched: {n}")
            check((n["find_runs"] > 0) == pod_index,
                  f"{' '.join(key)} host {node}: find_runs launches {n['find_runs']}")
            if pod_index:
                check(h["lookups"].endswith("feed misses 0"),
                      f"{' '.join(key)} host {node}: the engine missed run records: "
                      f"{h['lookups']}")
            say(f"{' '.join(key)} node {node}/2: {h['reads']} reads, mapping loop {h['rate']} "
                f"reads/s, pod total {h['pod_total']}"
                + (f", merge {h['merge_s']} s" if h["merge_s"] is not None else "")
                + (f"; pod index {json.dumps(h['traffic'])}; sharded lookups {h['lookups']}"
                   if pod_index else "")
                + f"; launches {json.dumps(n)} [{card}]")
        say(f"{' '.join(key)}: pod wall {wall:.2f} s (both processes, start to exit), mapping "
            f"loops {sum(h['rate'] for h in hosts)} reads/s summed over the hosts, "
            f"against t1 {runs['t1', key[1]][2]} reads/s [{card}]")
    same = [(pods["pod2", "SE"][0], runs["t1", "SE"][0], "pod2 SE", "t1 SE"),
            (pods["pod2-shard", "SE"][0], runs["t1", "SE"][0], "pod2-shard SE", "t1 SE"),
            (pods["pod2", "PE"][0], pods["pod2", "PE", "host"][0], "pod2 PE",
             "pod2 PE --no-tpu")]
    for a, b, name_a, name_b in same:
        check(a == b, f"SAM of {name_a} differs from {name_b}")
        say(f"SAM {name_a} == {name_b} apart from @PG")
    totals = {}
    for key, (_, _, hosts) in pods.items():
        if key[-1] != "host":
            for h in hosts:
                for k, v in h["launches"].items():
                    totals[k] = totals.get(k, 0) + v
    return totals


PY_SE_READS = 10_000  # phase Py (a): the first SE chunk
PY_PE_PAIRS = 5_000  # and the first 5 000 pairs, as one chunk
PY_CLI_SE, PY_CLI_PE = 1_000, 500  # phase Py (b): the CLI under the variable
PY_SHARD_READS, PY_RESCUE_READS = 1_000, 200  # phase Py (c)


def write_records(path, records):
    with open(path, "wb") as f:
        for r in records:
            f.write(b"@" + r.name.encode() + b"\n" + r.seq + b"\n+\n" + r.qual + b"\n")


def sam_records(path) -> bytes:
    """A SAM file's records: every line but the header's."""
    with open(path, "rb") as f:
        return b"".join(line for line in f if not line.startswith(b"@"))


def python_mapper(torch, card, ref, reads):
    """Phase Py: the Python mapper (the JAX runner's branch for a host
    without its library). (a) Through the library API with the engine's
    helpers loaded: phase_a_chunk, BatchAligner on the card, phase_b_chunk
    over the first SE chunk and the first 5 000 pairs, each equal to the
    engine's CLI run (-t 1) on a FASTQ of just those reads; (b) the CLI
    under RABBITSALIGN_TPU_NO_NATIVE in a subprocess on the card, equal to
    the same call with --no-tpu; (c) find_nams_sharded and
    find_nams_rescue_sharded on a one-shard ShardedIndex on the card,
    equal to the host find_nams. Returns the launches of its kernels."""
    phase("Py: the Python mapper (phase_a_chunk -> BatchAligner on the card -> phase_b_chunk)")
    from rabbitsalign_tpu_torch.align.aligner import Aligner, AlignmentParameters
    from rabbitsalign_tpu_torch.chain.nams import find_nams, find_nams_rescue
    from rabbitsalign_tpu_torch.chain.sharded_nams import (find_nams_rescue_sharded,
                                                           find_nams_sharded)
    from rabbitsalign_tpu_torch.cli import main
    from rabbitsalign_tpu_torch.io.fastq import InputBuffer
    from rabbitsalign_tpu_torch.io.sam import CIGAR_OPS_M, Sam
    from rabbitsalign_tpu_torch.map.common import InsertSizeDistribution, MappingParameters
    from rabbitsalign_tpu_torch.map.randomness import MinstdRand
    from rabbitsalign_tpu_torch.map.stats import AlignmentStatistics
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import shard_cuda, sw_cuda, tb_cuda
    from rabbitsalign_tpu_torch.ops.batch_extend import DEFAULT_BUCKETS, BatchAligner
    from rabbitsalign_tpu_torch.parallel.sharding import ShardedIndex, make_mesh
    from rabbitsalign_tpu_torch.pipeline.batched import (native_available, phase_a_chunk,
                                                         phase_b_chunk)
    from rabbitsalign_tpu_torch.seed.randstrobes import randstrobes_query
    from tests.torch_extend_cases import bucket_arrays, gap_pairs, mixed_pairs

    check(native_available(), "the engine's helpers are off in this process")
    t_phase = time.perf_counter()
    index = load_index(ref)
    params, refs = index.parameters, index.references
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = mp.rescue_level * index.filter_cutoff  # the runner's, at level 2
    chunks = {"SE": next(InputBuffer(reads["SE"][1], "", PY_SE_READS).chunks()),
              "PE": next(InputBuffer(reads["PE"][1], reads["PE"][2], PY_PE_PAIRS).chunks())}
    totals = {"sw_forward": 0, "sw_traceback": 0, "find_runs": 0}

    # the BatchAligner's layout on the card against the plain forward and
    # packed walk on the same card tensors, at its three buckets
    sw = sw_cuda.SwParams(ap.match, ap.mismatch, ap.gap_open, ap.gap_extend)
    for Q, T, B in DEFAULT_BUCKETS:
        q_t, t_t, qlen, tlen = bucket_arrays(
            mixed_pairs(Q, T, B - 7, seed=Q + T) + gap_pairs(Q, T, seed=T), Q, T)
        buf = torch.from_numpy(px.pack_input(q_t, t_t, qlen, tlen)).to(DEVICE)
        got = px.extend_batch_packed(buf, Q, T, sw)
        fwd = sw_cuda.sw_forward_plain(buf[:Q], buf[Q:Q + T], torch.from_numpy(qlen).to(DEVICE),
                                       torch.from_numpy(tlen).to(DEVICE), sw, torch.int32)
        want = tb_cuda.sw_traceback_packed_plain(fwd[3], *fwd[:3])
        err = max_abs_err(torch, [(got, want)])
        check(err == 0, f"Py: extend_batch_packed at ({Q}, {T}) x {B} differs from its plain "
              f"version (max_abs_err {err})")
        say(f"Py: extend_batch_packed at ({Q}, {T}) x {B} (mixed and gap pairs) equals the plain "
            f"forward and packed walk on the card, max_abs_err 0")

    # (a) the library API: one chunk each, seeded with chunk index 0, as
    # the CLI's only chunk
    for name, (_, r1, r2, r3) in chunks.items():
        files = [WORK / f"py.{name}.1.fq"] + ([WORK / f"py.{name}.2.fq"] if r2 else [])
        for path, recs in zip(files, (r1, r2)):
            write_records(path, recs)
        out = WORK / f"py.{name}.engine.sam"
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            rc = main([str(ref), *map(str, files), "--use-index", "--no-progress", "-t", "1",
                       "--device", DEVICE, "-o", str(out)])
        check(rc == 0, f"Py {name}: the engine's CLI run exited {rc}:\n{log.getvalue()[-3000:]}")
        want = sam_records(out)
        out.unlink()
        aligner, stats, isize = Aligner(ap), AlignmentStatistics(), InsertSizeDistribution()
        batch = BatchAligner(ap, 1024, device=DEVICE)  # the CLI's --tpu-batch
        engine = MinstdRand(0)
        engine.seed(0)
        torch.cuda.synchronize()
        sw_cuda.launches = sw_cuda.launches_i16 = tb_cuda.launches = px.packed_calls = 0
        t0 = time.perf_counter()
        work, n = phase_a_chunk(r1, r2, r3, [], isize, aligner, batch, mp, params, refs, index,
                                engine)
        t1 = time.perf_counter()
        token = batch.dispatch()
        t2 = time.perf_counter()
        infos = batch.collect(token)
        t3 = time.perf_counter()
        sam = Sam(refs, CIGAR_OPS_M, "", True, False)
        phase_b_chunk(work, infos, sam, stats, isize, aligner, mp, params, refs, engine)
        t4 = time.perf_counter()
        got = sam.take().encode()
        launches = {"sw_forward": sw_cuda.launches, "sw_forward_i16": sw_cuda.launches_i16,
                    "sw_traceback": tb_cuda.launches, "extend_packed": px.packed_calls}
        check(got == want, f"Py {name}: the Python mapper's SAM differs from the engine's CLI run")
        check(launches["sw_forward"] > 0 and launches["sw_traceback"] > 0 and
              launches["sw_forward_i16"] == 0,
              f"Py {name}: the extend kernels did not launch as expected: {launches}")
        totals["sw_forward"] += launches["sw_forward"]
        totals["sw_traceback"] += launches["sw_traceback"]
        say(f"Py {name}: {n} reads, SAM == the engine's CLI run (-t 1) on the same reads; "
            f"{n / (t4 - t0):.1f} reads/s: phase A {t1 - t0:.3f} s, dispatch {t2 - t1:.3f} s, "
            f"collect {t3 - t2:.3f} s, phase B {t4 - t3:.3f} s; jobs on the card "
            f"{batch.n_device_jobs}, refused by every bucket {batch.n_host_jobs}, redone on the "
            f"host {batch.n_fallbacks}; launches {json.dumps(launches)} [{card}]")

    # (b) the CLI under the variable, on the card and with --no-tpu
    env = dict(os.environ, PYTHONPATH=str(ROOT), RABBITSALIGN_TPU_NO_NATIVE="1")
    small = {"SE": [chunks["SE"][1][:PY_CLI_SE]],
             "PE": [chunks["PE"][1][:PY_CLI_PE], chunks["PE"][2][:PY_CLI_PE]]}
    for name, parts in small.items():
        files = [WORK / f"py.cli.{name}.{i}.fq" for i in range(len(parts))]
        for path, recs in zip(files, parts):
            write_records(path, recs)
        res = {}
        for mode, extra in (("cuda", ["--device", DEVICE]), ("host", ["--no-tpu"])):
            out = WORK / f"py.cli.{name}.{mode}.sam"
            cmd = [sys.executable, "-m", "rabbitsalign_tpu_torch.cli", str(ref), *map(str, files),
                   "--use-index", "--no-progress", "-v", *extra, "-o", str(out)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                               timeout=600)
            wall = time.perf_counter() - t0
            check(p.returncode == 0, f"Py CLI {name} {mode} exited {p.returncode}:\n"
                  f"{p.stderr[-3000:]}")
            m = re.search(r"Mapped (\d+) reads in ([0-9.]+) s \((\d+) reads/s\)", p.stderr)
            k = re.search(r"Kernel launches: (.*)", p.stderr)
            check(m and k and "RABBITSALIGN_TPU_NO_NATIVE" in p.stderr,
                  f"Py CLI {name} {mode}: no Python mapper lines in the log:\n{p.stderr[-3000:]}")
            jobs = re.search(r"Device extend: (.*)", p.stderr)
            with open(out, "rb") as f:
                res[mode] = (b"".join(line for line in f if not line.startswith(b"@PG")),
                             int(m.group(1)), int(m.group(3)), wall, json.loads(k.group(1)),
                             jobs.group(1) if jobs else "")
            out.unlink()
        n_cuda, n_host = res["cuda"][4], res["host"][4]
        check(res["cuda"][0] == res["host"][0],
              f"Py CLI {name}: the SAM on the card differs from --no-tpu")
        check(n_cuda["extend_packed"] > 0 and n_cuda["sw_forward"] > 0 and
              n_cuda["sw_traceback"] > 0, f"Py CLI {name}: the extend kernels never "
              f"launched on the card: {n_cuda}")
        check(n_host["extend_packed"] == 0 and n_host["sw_forward"] == 0,
              f"Py CLI {name} --no-tpu launched kernels: {n_host}")
        totals["sw_forward"] += n_cuda["sw_forward"]
        totals["sw_traceback"] += n_cuda["sw_traceback"]
        say(f"Py CLI {name} under RABBITSALIGN_TPU_NO_NATIVE: {res['cuda'][1]} reads, SAM on the "
            f"card == --no-tpu apart from @PG; mapping loop {res['cuda'][2]} reads/s on the card, "
            f"{res['host'][2]} reads/s with --no-tpu (calls {res['cuda'][3]:.1f} s and "
            f"{res['host'][3]:.1f} s); {res['cuda'][5]}; launches {json.dumps(n_cuda)} [{card}]")

    # (c) the sharded index's NAMs on the card against the host find_nams
    sharded = ShardedIndex(make_mesh(1, DEVICE), index)
    torch.cuda.synchronize()
    shard_cuda.launches_find_runs = 0
    n_nams = n_rescue = 0
    t_dev = t_host = 0.0
    rescue_cutoff = mp.rescue_cutoff
    for i, rec in enumerate(chunks["SE"][1][:PY_SHARD_READS]):
        q = randstrobes_query(rec.seq, params)
        t0 = time.perf_counter()
        frac, got = find_nams_sharded(q, sharded)
        t1 = time.perf_counter()
        want = find_nams(q, index)
        t_dev, t_host = t_dev + t1 - t0, t_host + time.perf_counter() - t1
        key = lambda n: (n.query_start, n.query_end, n.ref_start, n.ref_end, n.ref_id, n.n_hits,
                         n.score, n.is_rc)
        check(frac == want[0] and list(map(key, got)) == list(map(key, want[1])),
              f"Py: find_nams_sharded differs from find_nams on read {rec.name}")
        n_nams += len(got)
        if i < PY_RESCUE_READS:
            got = find_nams_rescue_sharded(q, sharded, rescue_cutoff)
            check(list(map(key, got)) ==
                  list(map(key, find_nams_rescue(q, index, rescue_cutoff))),
                  f"Py: find_nams_rescue_sharded differs from find_nams_rescue on {rec.name}")
            n_rescue += len(got)
    n_find = shard_cuda.launches_find_runs
    check(n_find > 0, "Py: find_runs never launched for find_nams_sharded")
    totals["find_runs"] += n_find
    say(f"Py sharded NAMs: find_nams_sharded == find_nams on {PY_SHARD_READS} reads ({n_nams} "
        f"NAMs), find_nams_rescue_sharded == find_nams_rescue on {PY_RESCUE_READS} ({n_rescue}); "
        f"find_runs launches {n_find}; {t_dev * 1e3 / PY_SHARD_READS:.3f} ms a read with the "
        f"one-shard index on the card against {t_host * 1e3 / PY_SHARD_READS:.3f} ms on the host "
        f"index [{card}]")
    say(f"phase Py: {time.perf_counter() - t_phase:.1f} s")
    return totals



API_SE_READS, API_PE_PAIRS = 10_000, 5_000  # phase API: the first SE chunk and 5 000 pairs
API_MISSES = 4096  # random keys added to sharded_find's strobes


def api(torch, card, ref, reads):
    """Phase API: the public entry points no CLI path calls, at full width
    on the card: an engine at -t 1 for the first SE chunk and one for the
    first 5 000 pairs, the default buckets at the CLI's batch size. Every
    planned batch through the three upload layouts (`fill_batch`,
    `fill_batch_q`, `fill_batch_q2`) and four extends, byte-equal; on one
    batch a bucket `extend_batch_device`'s runs and meta, packed, equal to
    them; `job_shapes` and `isize_per_chunk`; `sharded_find` on the card
    against the host index; `data_parallel_extend` on [cuda:0] and
    [cuda:0, cuda:0] against one forward launch. Prints each layout's
    upload bytes a pair, its host-paced ms a batch for fill, upload, extend
    and copy back, and its extend's time on the card. Returns the
    launches of its kernels."""
    phase("API: the engine's fills and telemetry, the resident, grouped and unpacked extends, "
          "sharded_find and data_parallel_extend on the card")
    from rabbitsalign_tpu_torch.align.aligner import AlignmentParameters
    from rabbitsalign_tpu_torch.io.fastq import InputBuffer
    from rabbitsalign_tpu_torch.map.common import MappingParameters
    from rabbitsalign_tpu_torch.native.engine import NativeEngine, engine_buckets
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import shard_cuda, sw_cuda, tb_cuda
    from rabbitsalign_tpu_torch.parallel.sharding import data_parallel_extend, sharded_find
    import numpy as np

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    index = load_index(ref)
    ap = AlignmentParameters()
    sw = sw_cuda.SwParams(ap.match, ap.mismatch, ap.gap_open, ap.gap_extend)
    batch = 1024  # the CLI's --tpu-batch

    def engine(**kw):
        return NativeEngine(index, index.parameters, index.references, ap,
                            MappingParameters(r=150, rescue_cutoff=2 * index.filter_cutoff, **kw))

    chunks = {"SE": next(InputBuffer(reads["SE"][1], "", API_SE_READS).chunks()),
              "PE": next(InputBuffer(reads["PE"][1], reads["PE"][2], API_PE_PAIRS).chunks())}
    layouts = ("fill_batch", "fill_batch_q", "fill_batch_q2")
    # layout -> [fill, upload, extend, copy back] seconds; its upload bytes;
    # the batches' columns (pair slots)
    host = {k: [0.0, 0.0, 0.0, 0.0] for k in layouts}
    up_bytes = dict.fromkeys(layouts, 0)
    n_pairs = n_batches = 0
    timed = None  # the first batch of the tight bucket, for the card times
    ref_dev = None
    tight = engine_buckets(150)[0]
    extend = {  # layout -> its extend (on_card, Q, T, sub)
        "fill_batch": lambda buf, Q, T, sub: px.extend_batch_packed(buf, Q, T, sw),
        "fill_batch_q": lambda buf, Q, T, sub: px.extend_batch_packed_resident(
            buf, ref_dev, Q, T, sw, sub),
        "fill_batch_q2": lambda buf, Q, T, sub: px.extend_batch_packed_resident_q2(
            buf, ref_dev, Q, T, sw, sub)}
    counts = {"sw_forward": 0, "sw_traceback": 0, "find_runs": 0}
    with sw16(None):
        torch.cuda.synchronize()
        sw_cuda.launches = sw_cuda.launches_i16 = tb_cuda.launches = 0
        shard_cuda.launches_find_runs = 0
        for name, (_, r1, r2, r3) in chunks.items():
            eng = engine()
            if ref_dev is None:
                ref_dev = px.resident_ref_codes(eng.ref_codes(), dev)
            ch = eng.chunk_a(r1, r2, r3, 0)
            n_jobs = ch.n_jobs
            plans = eng.plan_batches(ch, batch)
            unpacked = set()
            for idxs, Q, T, B, sub in plans:
                outs, on_card = {}, {}
                for layout in layouts:
                    t0 = time.perf_counter()
                    if layout == "fill_batch":
                        buf = eng.fill_batch(ch, idxs, B, Q, T)
                    else:
                        buf = getattr(eng, layout)(ch, idxs, B, Q)
                    t1 = time.perf_counter()
                    on_card[layout] = torch.from_numpy(buf).pin_memory().to(dev,
                                                                            non_blocking=True)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    out = extend[layout](on_card[layout], Q, T, sub)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    outs[layout] = out.cpu()
                    t4 = time.perf_counter()
                    for i, dt in enumerate((t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                        host[layout][i] += dt
                    up_bytes[layout] += buf.nbytes
                full = on_card["fill_batch"]
                outs["grouped"] = px.extend_batch_packed_grouped(full, Q, T, sw, sub).cpu()
                if timed is None and Q == tight[0]:
                    timed = (Q, T, B, sub, on_card)
                want = outs["fill_batch"]
                for k, got in outs.items():
                    check(torch.equal(got, want), f"API {name}: at ({Q}, {T}) B={B} the "
                          f"{k} extend differs from extend_batch_packed(fill_batch)")
                if (Q, T) not in unpacked:  # the unpacked walk, once a bucket
                    unpacked.add((Q, T))
                    lens = full[Q + T:Q + T + 4].to(torch.int32)
                    before = tb_cuda.launches
                    res = px.extend_batch_device(full[:Q], full[Q:Q + T], lens[0] | (lens[1] << 8),
                                                 lens[2] | (lens[3] << 8), sw)
                    check(tb_cuda.launches == before + 1, "API: extend_batch_device did not "
                          "launch the unpacked traceback kernel once")
                    packed = tb_cuda.pack_rle_output(res[3], res[4], *res[:3], res[5]).cpu()
                    check(torch.equal(packed, want), f"API {name}: at ({Q}, {T}) B={B} "
                          f"extend_batch_device's runs and meta, packed, differ from the packed "
                          f"extend")
                eng.set_device_results(ch, outs["fill_batch_q2"].numpy(), Q + T - 1, idxs)
                n_pairs += B
                n_batches += 1
            eng.chunk_b_bytes(ch)
            shapes = eng.job_shapes()
            in_buckets = sum(n for _, _, n in shapes["buckets"])
            check(in_buckets + shapes["unbucketed"] == n_jobs and
                  int(shapes["qlen_hist_32"].sum()) == n_jobs and
                  int(shapes["tlen_hist_32"].sum()) == n_jobs,
                  f"API {name}: job_shapes does not sum to the chunk's {n_jobs} jobs: {shapes}")
            check(not eng.isize_per_chunk(), f"API {name}: isize_per_chunk without pe_ref_async")
            qh, th = ({32 * i: int(v) for i, v in enumerate(shapes[k]) if v}
                      for k in ("qlen_hist_32", "tlen_hist_32"))
            say(f"API {name}: {n_jobs} jobs, {len(plans)} batches, every batch byte-equal in "
                f"extend_batch_packed(fill_batch), extend_batch_packed_resident(fill_batch_q), "
                f"extend_batch_packed_resident_q2(fill_batch_q2) and "
                f"extend_batch_packed_grouped(fill_batch, sub), and extend_batch_device packed "
                f"equal on {len(unpacked)} bucket(s); job_shapes buckets {shapes['buckets']}, "
                f"unbucketed {shapes['unbucketed']}, small_to_host {shapes['small_to_host']}, "
                f"qlen_hist_32 {qh}, tlen_hist_32 {th} (bins by lower bound)")
            eng.close()
        # isize_per_chunk under pe_ref_async, after the PE chunk on the host
        eng = engine(pe_ref_async=True)
        _, r1, r2, r3 = chunks["PE"]
        eng.chunk_b_bytes(eng.chunk_a(r1, r2, r3, 0))
        check(eng.isize_per_chunk(), "API: isize_per_chunk is false with pe_ref_async")
        say(f"API: isize_per_chunk True with pe_ref_async (isize {eng.isize()}), False without")
        eng.close()

        # sharded_find on the card against the host index
        keys, _ = chunk_strobes(index, reads["SE"][1])
        rng = np.random.default_rng(16)
        keys = np.concatenate([keys, rng.integers(0, 2**63, API_MISSES, dtype=np.uint64),
                               np.asarray(index.hashes[:1])])
        t0 = time.perf_counter()
        got = sharded_find([dev], index, keys)
        t1 = time.perf_counter()
        want = index.find(keys)
        check(np.array_equal(got, want), "API: sharded_find on the card differs from the host "
              "index's find")
        say(f"API: sharded_find([{dev}]) == index.find on {keys.shape[0]} keys (the chunk's "
            f"strobes, {API_MISSES} random keys and the smallest hash; {int((got < 0).sum())} "
            f"absent), {(t1 - t0) * 1e3:.1f} ms with the shard's upload")

        # data_parallel_extend on one and two entries against one launch
        check(timed is not None, "API: the SE chunk planned no batch of the tight bucket")
        Q, T, B, sub, on_card = timed
        full = on_card["fill_batch"]
        lens = full[Q + T:Q + T + 4].to(torch.int32)
        qlen, tlen = lens[0] | (lens[1] << 8), lens[2] | (lens[3] << 8)
        one = sw_cuda.sw_forward(full[:Q], full[Q:Q + T], qlen, tlen, sw)[:3]
        cells = int((qlen.long() * tlen.long()).sum())
        for devices in ([dev], [dev, dev]):
            res = data_parallel_extend(devices, sw, full[:Q].T, full[Q:Q + T].T, qlen, tlen)
            check(all(torch.equal(a, b) for a, b in zip(res[:3], one)) and int(res[3]) == cells,
                  f"API: data_parallel_extend on {devices} differs from one sw_forward launch")
        say(f"API: data_parallel_extend on [{dev}] and [{dev}, {dev}] at ({Q}, {T}) B={B} == "
            f"one sw_forward launch (score, t_end, q_end), total_cells {cells}")
        torch.cuda.synchronize()
        counts = {"sw_forward": sw_cuda.launches, "sw_traceback": tb_cuda.launches,
                  "find_runs": shard_cuda.launches_find_runs}
        check(sw_cuda.launches_i16 == 0 and all(counts.values()),
              f"API: a kernel of the phase never launched: {counts}")

        # per layout: upload bytes a pair, host-paced ms a batch, and the
        # extend's time on the card on the first tight batch
        card_ms = {layout: device_ms(torch, lambda: extend[layout](on_card[layout], Q, T, sub), 20)
                   for layout in layouts}
    for layout in layouts:
        f, u, e, c = (x * 1e3 / n_batches for x in host[layout])
        say(f"API layout {layout}: {up_bytes[layout] / n_pairs:.2f} upload bytes a pair (a "
            f"column of the batch); "
            f"host-paced a batch (mean of {n_batches}, {n_pairs / n_batches:.0f} columns): fill "
            f"{f:.4f} ms, upload {u:.4f} ms, extend {e:.4f} ms, copy back {c:.4f} ms; extend on "
            f"the card at ({Q}, {T}) B={B}: {card_ms[layout]:.4f} ms [{card}]")
    say(f"phase API: launches {json.dumps(counts)}; {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    torch, card = environment()
    entries = build()
    err, times, bounds = kernels(torch, card, entries)
    split_launches = ilp(torch, card)
    ref, reads = make_data()
    index = load_index(ref)
    seed_err, seed_times, seed_bounds, library = seed_kernels(torch, card, index, reads["SE"][1])
    shard_err, shard_times, shard_bounds, shard_library = shard_kernels(torch, card, index,
                                                                        reads["SE"][1])
    chain_err, chain_times, chain_bounds, chain_library, chain_launches = chain_kernels(
        torch, card, index, reads["SE"][1])
    del index
    err.update(seed_err, **shard_err, **chain_err)
    times.update(seed_times, **shard_times, **chain_times)
    bounds.update(seed_bounds, **shard_bounds, **chain_bounds)
    library.update(shard_library, **chain_library)
    launches, runs = main_path(torch, card, reads)
    for k, v in chain_launches.items():
        launches[k] = launches.get(k, 0) + v
    for k, v in multi(torch, card, reads, runs).items():
        launches[k] += v
    for k, v in pod(card, reads, runs).items():
        if k in launches:
            launches[k] += v
    for k, v in python_mapper(torch, card, ref, reads).items():
        launches[k] += v
    for k, v in api(torch, card, ref, reads).items():
        launches[k] += v
    launches["sw_forward_split"] = split_launches
    # no single PyTorch call computes an affine-gap Smith-Waterman pass,
    # its traceback, the probe's compare or the seeding: library_ms is
    # null for those; the lookups' is torch.searchsorted
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # named by the failure line, after its traceback
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
    sys.exit(code)
