#!/usr/bin/env python3
"""Times of the phase-A kernels of two checkouts of the port on one NVIDIA
GPU, on the same inputs: the first SE chunk (10 000 reads) of chip_smoke.py's
40 Mbp data, its host-seeded strobes as the run lookup's keys, and the
index as one shard. For each checkout, in a process of its own:

  * the run lookup (`shard_cuda.find_runs` and `gather_runs`): search and
    gather together and each alone, after an L2 flush and back to back, on
    the card (calls queued behind a sleep kernel);
  * the index lookup (`seed_cuda.index_find`) of the chunk's host-seeded
    strobes, after an L2 flush and back to back, on the card;
  * the seeding kernel on the card, back to back and after a flush, and
    `seed_device.seed_and_find` with the copy of its arrays to the host,
    host-paced (as `_preseed` makes it); for a checkout whose seeding kernel
    writes the (B, 2M) slots, also the torch compaction alone, host-paced;
  * each CUDA kernel's device time from torch.profiler.

The checkouts take turns, other, this, this, other, on one card. Run from
the root of a checkout, with the other one unpacked beside it (git archive):

    python3 compare_phase_a.py OTHER_CHECKOUT

Work files go to build/compare_phase_a/ (git-ignored).
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "compare_phase_a"


def make_inputs() -> Path:
    """chip_smoke's data and index, then the arrays each checkout reads."""
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from tests.torch_seed_cases import code_batch

    cs.WORK = WORK
    WORK.mkdir(parents=True, exist_ok=True)
    ref, reads = cs.make_data()
    index = cs.load_index(ref)
    strobes, _ = cs.chunk_strobes(index, reads["SE"][1])
    misses = np.random.RandomState(2).randint(0, 2**63, 4096, dtype=np.int64).astype(np.uint64)
    keys = np.concatenate([strobes, misses, np.array([2**64 - 1, index.hashes[0]], np.uint64)])
    with open(reads["SE"][1], "rb") as f:
        chunk = [line.rstrip(b"\n") for i, line in zip(range(4 * 10_000), f) if i % 4 == 1]
    codes, lens = code_batch(chunk)
    sp, rp = index.parameters.syncmer, index.parameters.randstrobe
    out = WORK / "inputs.npz"
    np.savez(out, keys=keys.view(np.int64), n_strobes=strobes.size,
             hashes=index.hashes.view(np.int64),
             positions=index.positions.view(np.int32), packed=index.packed.view(np.int32),
             buckets=np.asarray(index.randstrobe_start_indices, np.uint64).view(np.int64),
             bits=index.bits, fc=index.filter_cutoff, codes=codes, lens=lens,
             seed_args=np.array([sp.k, sp.s, sp.t_syncmer, rp.w_min, rp.w_max, rp.q,
                                 rp.max_dist, 256]))
    return out


def measure(tree: Path, inputs: Path, tag: str) -> dict:
    """The times of one checkout (run in a process of its own)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rabbitsalign_tpu_torch.ops import cuda_build, seed_cuda, seed_device, shard_cuda

    if not Path(shard_cuda.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {shard_cuda.__file__}, not the checkout {tree}")
    cuda_build.build_kernels()
    dev = torch.device("cuda")
    d = np.load(inputs)
    t = {k: torch.from_numpy(d[k]).to(dev)
         for k in ("keys", "hashes", "positions", "packed", "buckets", "codes", "lens")}
    bits, fc = int(d["bits"]), int(d["fc"])
    args = [int(x) for x in d["seed_args"]]
    h, p, k, b, q = t["hashes"], t["positions"], t["packed"], t["buckets"], t["keys"]
    codes, lens = t["codes"], t["lens"]

    def device_ms(fn, reps=20):
        """ms a call on the card: the calls queued behind a sleep kernel."""
        fn()
        torch.cuda.synchronize()
        cycles = 1 << 22
        for _ in range(6):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            queued = not s.query()
            e.synchronize()
            if queued:
                return s.elapsed_time(e) / reps
            cycles *= 4
        raise RuntimeError("the host could not queue the timed calls ahead of the card")

    def host_ms(fn, reps=20):
        """ms a call host-paced: back-to-back calls between two events."""
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    def kernel_us(fn, reps=20):
        """Device us a call of each CUDA kernel that fn launches."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / reps for e in prof.key_averages()
                if e.self_device_time_total > 0}

    scratch = torch.empty(32 << 20, dtype=torch.int32, device=dev)

    def flush():
        scratch.fill_(1)

    flush_ms = device_ms(flush)
    gpos, count = shard_cuda.find_runs(h, h.numel(), 0, b, bits, q)
    walk = (count > 0) & (count <= fc)
    width = torch.where(walk, count, 0)
    dst = torch.where(walk, torch.cumsum(width, 0) - width, -1)
    outs = [torch.zeros(max(int(width.sum()), 1), dtype=torch.int32, device=dev)
            for _ in range(2)]

    def search():
        shard_cuda.find_runs(h, h.numel(), 0, b, bits, q)

    def gather():
        shard_cuda.gather_runs(p, k, gpos, count, 0, fc, dst, *outs)

    def lookup():
        search()
        gather()

    res = {"tag": tag, "flush_ms": flush_ms,
           "find_runs_cold": device_ms(lambda: (flush(), lookup())) - flush_ms,
           "search_cold": device_ms(lambda: (flush(), search())) - flush_ms,
           "gather_cold": device_ms(lambda: (flush(), gather())) - flush_ms,
           "find_runs_warm": device_ms(lookup), "search_warm": device_ms(search),
           "gather_warm": device_ms(gather), "find_runs_kernels_us": kernel_us(lookup)}
    strobes = q[:int(d["n_strobes"])]

    def find():
        seed_cuda.index_find(h, b, bits, strobes)

    res.update(index_find_cold=device_ms(lambda: (flush(), find())) - flush_ms,
               index_find_warm=device_ms(find), index_find_kernels_us=kernel_us(find))

    if hasattr(seed_cuda, "launch_seed_randstrobes"):  # compacted strobes in one buffer
        buf = seed_cuda.seed_buffer(codes.shape[0], args[-1], dev)

        def seed():
            seed_cuda.launch_seed_randstrobes(codes, lens, *args, buf)

        def to_host():
            out, _ = seed_device.seed_and_find(codes, lens, h, b, *args, bits)
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream().synchronize()
    else:  # (B, 2M) slots, compacted by torch, seven copies back
        clamped = lens.clamp(min=0)

        def seed():
            return seed_cuda.seed_randstrobes(codes, clamped, *args)

        def to_host():
            for x in seed_device.seed_and_find(codes, lens, h, b, *args, bits):
                x.cpu()

        M = args[-1]
        slots = seed()

        def compaction():
            hh, st, en, nf, nr, tie = slots
            row_ok = ~(tie | (lens < 0))
            n = torch.where(row_ok, nf + nr, 0)
            torch.where(row_ok, nf + nr, -1).to(torch.int32)
            torch.cumsum(n.to(torch.int64), 0)
            slot = torch.arange(2 * M, device=dev)[None, :]
            valid = torch.where(slot < M, slot < nf[:, None], slot - M < nr[:, None]) & \
                row_ok[:, None]
            idx = valid.flatten().nonzero().squeeze(1)
            for x in (hh, st, en, (slot >= M).expand(valid.shape)):
                x.flatten()[idx]

        res["compaction_host"] = host_ms(compaction)
    res["seed_kernel"] = device_ms(seed)
    res["seed_kernel_cold"] = device_ms(lambda: (flush(), seed())) - flush_ms
    res["seed_and_find_to_host"] = host_ms(to_host)
    res["seed_kernels_us"] = kernel_us(seed)
    return res


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--measure":
        res = measure(Path(sys.argv[2]).resolve(), Path(sys.argv[3]), sys.argv[4])
        print("MEASURE " + json.dumps(res), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip()
    inputs = make_inputs()
    for tag, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure",
                              str(tree), str(inputs), tag], capture_output=True, text=True,
                             timeout=600)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("MEASURE ")]
        if res.returncode != 0 or not lines:
            print(f"{tag} ({tree}) failed:\n{res.stderr[-3000:]}", file=sys.stderr)
            return 1
        print(f"{lines[-1]} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
