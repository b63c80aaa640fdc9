#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rabbitsalign_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the result line:

1. Environment: a CUDA device is present; the card's name and power
   limit (nvidia-smi), torch, CUDA and nvcc versions; g++ links -lz (the
   native engine needs zlib).
2. Build: the two CUDA kernels (csrc/, nvcc for sm_90a) and the native
   engine (g++), from the checkout's sources; build times.
3. Kernels against their plain PyTorch versions on the card, at each
   engine bucket shape at its production batch width, on planted, indel,
   N-run, tandem-repeat, junk, empty and >32-run pairs: forward outputs
   (score, t_end, q_end; dirs on valid cells), traceback outputs (runs,
   meta) and the fused packed transfer buffer must be equal byte for
   byte (tolerance 0: everything is integer). Kernel and plain times
   with CUDA events at the tight bucket.
4. The main path through the CLI at a size users run: a 40 Mbp simulated
   genome (bench.py's generator), 48k x 150 bp SE reads and 24k x 2x150 bp
   PE pairs; the index built once with `-i`, then mapped with
   `--use-index --device cuda` and again with `--no-tpu` (host SSW). The
   SAM of both runs must be identical apart from @PG, the device runs must
   have dispatched extend batches, and both kernels must have launched.

The line before last is a JSON object with each kernel's launches in
phase 4 and its phase-3 error and times; the last line is
{"ok": true, "device": {...}}. Work files go to build/chip_smoke/.
"""

import contextlib
import io
import json
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
N_SE_READS = 48_000
N_PE_PAIRS = 24_000
REQUIRED = ("rabbitsalign_tpu_torch/__init__.py", "rabbitsalign_tpu_torch/csrc/sw_forward.cu",
            "rabbitsalign_tpu_torch/csrc/sw_traceback.cu", "rabbitsalign_tpu/native/engine.cpp",
            "bench.py", "tests/torch_extend_cases.py")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def run_cmd(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600, **kw)


def environment():
    say("== phase 1: environment")
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
    say("== phase 2: build")
    import os

    from rabbitsalign_tpu_torch.ops import cuda_build

    cuda_build.build_kernels(extra_flags=("-Xptxas", "-v"))
    say(f"CUDA kernels built in {cuda_build.build_seconds:.2f} s -> "
        f"{cuda_build.LIB_PATH.relative_to(ROOT)}")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say("  " + line.strip())
    # a fresh engine cache inside the checkout: always built from its sources
    os.environ["RABBITSALIGN_TPU_TORCH_CACHE"] = str(WORK / "engine_cache")
    from rabbitsalign_tpu_torch.native import build_engine

    t0 = time.perf_counter()
    path = build_engine()
    say(f"native engine built in {time.perf_counter() - t0:.2f} s -> {path.relative_to(ROOT)}")


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


def max_abs_err(torch, pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
               for a, b in pairs)


def kernels(torch, card):
    say("== phase 3: kernels against their plain versions")
    from rabbitsalign_tpu_torch.native.engine import engine_buckets
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda
    from tests.torch_extend_cases import mixed_pairs, q2_batch

    dev = torch.device(DEVICE)
    sw = sw_cuda.SwParams(2, 8, 12, 1)
    err = {"sw_forward": 0, "sw_traceback": 0}
    times = {}
    for i, (Q, T, bcap, groups) in enumerate(engine_buckets(150)):
        B = bcap * groups  # the widest dispatch the planner makes
        buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=Q * T), Q, seed=Q)
        buf = torch.from_numpy(buf).to(dev)
        ref = px.resident_ref_codes(genome, dev)
        q_t, t_t, qlen, tlen = px.unpack_q2(buf, ref, Q, T)
        k = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
        p = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
        qi = torch.arange(Q, device=dev)[:, None, None]
        ti = torch.arange(T, device=dev)[None, :, None]
        valid = (qi < qlen[None, None, :]) & (ti < tlen[None, None, :])
        e_f = max_abs_err(torch, list(zip(k[:3], p[:3])) + [(torch.where(valid, k[3], 0), p[3])])
        kt = tb_cuda.sw_traceback(k[3], *k[:3])
        e_t = max_abs_err(torch, zip(kt, tb_cuda.sw_traceback_plain(k[3], *k[:3])))
        fused = px.extend_batch_packed_resident_q2(buf, ref, Q, T, sw, bcap)
        runs_op, runs_len, meta = tb_cuda.sw_traceback_plain(p[3], *p[:3])
        plain = px._pack_rle_output(runs_op, runs_len, *p[:3], meta)
        torch.cuda.synchronize()
        same = torch.equal(fused, plain)
        fields = px.unpack_output(fused.cpu().numpy())
        n_overflow, n_aligned = int((fields[2] == 0xFFFF).sum()), int((fields[3] > 0).sum())
        say(f"bucket ({Q}, {T}) B={B}: forward max_abs_err {e_f}, traceback max_abs_err {e_t}, "
            f"fused output byte-equal {same}, {n_aligned} pairs aligned, {n_overflow} over 32 runs")
        check(e_f == 0 and e_t == 0 and same, f"kernel and plain version disagree at ({Q}, {T})")
        check(n_overflow > 0 and n_aligned > B // 2, f"degenerate test batch at ({Q}, {T})")
        err["sw_forward"] = max(err["sw_forward"], e_f)
        err["sw_traceback"] = max(err["sw_traceback"], e_t)
        if i == 0:  # the tight, high-volume bucket
            times["sw_forward"] = (
                time_ms(torch, lambda: sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw), 20),
                time_ms(torch, lambda: sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw), 3))
            times["sw_traceback"] = (
                time_ms(torch, lambda: tb_cuda.sw_traceback(k[3], *k[:3]), 20),
                time_ms(torch, lambda: tb_cuda.sw_traceback_plain(k[3], *k[:3]), 3))
            fused_ms = time_ms(torch, lambda: px.extend_batch_packed_resident_q2(
                buf, ref, Q, T, sw, bcap), 20)
            for name, (ms, plain_ms) in times.items():
                say(f"{name} at ({Q}, {T}) B={B}: kernel {ms:.4f} ms ({ms * 1e3 / B:.4f} us/pair), "
                    f"plain {plain_ms:.4f} ms ({plain_ms * 1e3 / B:.4f} us/pair) [{card}]")
            say(f"fused extend (unpack + both kernels + pack) at ({Q}, {T}) B={B}: "
                f"{fused_ms:.4f} ms ({fused_ms * 1e3 / B:.4f} us/pair) [{card}]")
    return err, times


def map_run(main, tag, argv):
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
    return out, n_reads, int(m.group(3)), n_reads / wall, wall, phases.group(1) if phases else ""


def without_pg(path) -> bytes:
    with open(path, "rb") as f:
        return b"".join(line for line in f if not line.startswith(b"@PG"))


def main_path(torch, card):
    say("== phase 4: main path")
    import bench
    from rabbitsalign_tpu_torch.cli import main
    from rabbitsalign_tpu_torch.ops import extend_device as px
    from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda

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

    base = ["--use-index", "-t", "1", "--no-progress"]
    configs = {"SE": [str(ref), str(se)], "PE": [str(ref), str(pe[0]), str(pe[1])]}
    device_runs, dispatches = {}, {}
    sw_cuda.launches = tb_cuda.launches = px.calls = 0
    for name, argv in configs.items():
        before = px.calls
        device_runs[name] = map_run(main, f"{name}.cuda", [*argv, *base, "--device", DEVICE])
        dispatches[name] = px.calls - before
    torch.cuda.synchronize()
    launches = {"sw_forward": sw_cuda.launches, "sw_traceback": tb_cuda.launches}
    host_runs = {name: map_run(main, f"{name}.host", [*argv, *base, "--no-tpu"])
                 for name, argv in configs.items()}
    for name in configs:
        for label, run in (("device", device_runs[name]), ("host-only", host_runs[name])):
            _, n, rate_log, rate_wall, wall, phases = run
            say(f"{name} {label}: {n} reads, mapping loop {rate_log} reads/s, whole CLI call "
                f"{rate_wall:.1f} reads/s ({wall:.2f} s) [{card}]; {phases}")
        check(without_pg(device_runs[name][0]) == without_pg(host_runs[name][0]),
              f"{name}: device SAM differs from the host-only SAM")
        say(f"{name}: device and host-only SAM identical apart from @PG")
    say(f"device extend dispatches {dispatches}, kernel launches {launches}")
    check(sum(dispatches.values()) > 0, "no extend batch was dispatched to the device")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    return launches


def main() -> int:
    torch, card = environment()
    build()
    err, times = kernels(torch, card)
    launches = main_path(torch, card)
    sources = {"sw_forward": ("rabbitsalign_tpu_torch/csrc/sw_forward.cu",
                              "rabbitsalign_tpu/ops/sw_pallas.py:464"),
               "sw_traceback": ("rabbitsalign_tpu_torch/csrc/sw_traceback.cu",
                                "rabbitsalign_tpu/ops/tb_pallas.py:254")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
