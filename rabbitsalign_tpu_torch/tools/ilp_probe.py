"""Cross-pair ILP probe of the forward kernel on an NVIDIA GPU: the
counterpart of tests/sanitize/ilp_probe.py.

Hypothesis: the production forward (`sw_forward`, one warp per pair, the
DP state in registers) runs each pair as one chain of dependent steps: a
lane waits for the previous lane's bottom row through a shuffle, then
computes its R cells, each waiting on the one above. A warp that holds 2
or 4 pairs (`sw_cuda.sw_forward_split`: the production design for each, a
shuffle chain a pair, the pairs' cells of a step in one basic block) gives
the scheduler independent chains to interleave, so one pair's shuffle and
DPX latency can hide under another's arithmetic, at the price of fewer
warps on the card and the selects that keep idle lanes' state. If the
per-step chain latency is exposed at B = 1024, split2 / production falls
below 1.

Method, as the TPU harness: the inputs of ilp_probe.py:216-227 (seed 7,
(Q, T, B) = (152, 256, 1024), an alignment planted in every third pair,
SwParams(2, 8, 12, 1)); the split kernels held bit-exact against the
production int32 kernel (score, t_end, q_end, and the (B, Q, T) dirs on
valid cells, compared directly); then paired-slope timing: K = 2 and
K = 10 chained launches on one stream, each writing (sum of the previous
scores and t_ends) & 3 into q[0, 0] on the device so no launch can start
before the previous one ends, timed with CUDA events; the slope over K
cancels the fixed costs. Nine trials with the variants interleaved; the
median slope is reported, and each split's median over production's, with
the card's name and power limit.

Run on a machine with an NVIDIA GPU (it refuses to run without one):

    python -m rabbitsalign_tpu_torch.tools.ilp_probe
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import sw_cuda
from ..ops.sw_cuda import SwParams

Q, T, B = 152, 256, 1024  # the production tight bucket at one group's width
PARAMS = SwParams(match=2, mismatch=8, gap_open=12, gap_extend=1)
K_LO, K_HI = 2, 10
TRIALS = 9
VARIANTS = ("production", "split2", "split4")


def probe_inputs() -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q_t (Q, B) u8, t_t (T, B) u8, qlen (B,) i32, tlen (B,) i32) on the
    CPU, drawn exactly as tests/sanitize/ilp_probe.py draws its (B, Q) and
    (B, T) arrays, then transposed to the port's layout."""
    rng = np.random.RandomState(7)
    q = rng.randint(0, 4, (B, Q)).astype(np.uint8)
    t = rng.randint(0, 4, (B, T)).astype(np.uint8)
    # plant real alignments so the dirs planes aren't trivial
    for i in range(0, B, 3):
        ql = rng.randint(100, Q)
        off = rng.randint(0, 40)
        t[i, off:off + ql] = q[i, :ql]
    qlen = rng.randint(100, Q + 1, B).astype(np.int32)
    tlen = rng.randint(150, T + 1, B).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(q.T)), torch.from_numpy(np.ascontiguousarray(t.T)),
            torch.from_numpy(qlen), torch.from_numpy(tlen))


def _variant(tag: str):
    if tag == "production":
        return lambda *x: sw_cuda.sw_forward(*x, PARAMS)
    return lambda *x: sw_cuda.sw_forward_split(*x, PARAMS, int(tag.removeprefix("split")))


def check_exact(inputs) -> None:
    """Raise unless sw_forward_split with 2 and 4 pairs a warp gives the
    production int32 kernel's score, t_end, q_end and (B, Q, T) dirs on
    valid cells."""
    q_t, t_t, qlen, tlen = inputs
    (Qi, _), Ti = q_t.shape, t_t.shape[0]
    if sw_cuda.pick_dtype(Qi, Ti, PARAMS) != torch.int32:
        raise RuntimeError("the production variant is the int32 kernel: unset RSB_SW16")
    ref = _variant("production")(*inputs)
    valid = sw_cuda.valid_cells(qlen, tlen, Qi, Ti)
    ref_dirs = torch.where(valid, ref[3], 0)
    for tag in VARIANTS[1:]:
        got = _variant(tag)(*inputs)
        for name, a, b in zip(("score", "t_end", "q_end"), got[:3], ref[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: {name} differs from the production kernel")
        if not torch.equal(torch.where(valid, got[3], 0), ref_dirs):
            raise AssertionError(f"{tag}: dirs differ from the production kernel on valid cells")


def _chain_ms(fn, inputs, K: int) -> float:
    """Milliseconds of K dependent launches of fn, by CUDA events."""
    q_t, t_t, qlen, tlen = inputs
    acc = torch.zeros((), dtype=torch.int64, device=q_t.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(K):
        q_t[0, 0] = (acc & 3).to(torch.uint8)
        score, t_end, _, _ = fn(q_t, t_t, qlen, tlen)
        acc = score.sum() + t_end.sum()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def paired_slopes(inputs, trials: int = TRIALS) -> Dict[str, List[float]]:
    """{variant: its `trials` paired slopes in ms per launch, sorted}. q_t
    is copied, since each chained launch rewrites q[0, 0]."""
    inputs = (inputs[0].clone(), *inputs[1:])
    fns = {tag: _variant(tag) for tag in VARIANTS}
    for fn in fns.values():  # warm-up
        _chain_ms(fn, inputs, K_LO)
        _chain_ms(fn, inputs, K_HI)
    slopes = {tag: [] for tag in fns}
    # variants interleaved within each trial, so drift hits all alike
    for _ in range(trials):
        for tag, fn in fns.items():
            slopes[tag].append((_chain_ms(fn, inputs, K_HI) - _chain_ms(fn, inputs, K_LO))
                               / (K_HI - K_LO))
    return {tag: sorted(v) for tag, v in slopes.items()}


def run(card: str, inputs) -> Dict[str, float]:
    """The exactness check and the paired-slope timing on `inputs` (those
    of `probe_inputs`, on the GPU); prints one line per variant and
    returns {variant: median ms}."""
    check_exact(inputs)
    (Qi, Bi), Ti = inputs[0].shape, inputs[1].shape[0]
    print(f"split2, split4: bit-exact vs production (score/t_end/q_end, dirs on valid cells) "
          f"at ({Qi}, {Ti}) x B{Bi}", flush=True)
    print(f"timing at ({Qi}, {Ti}) x B{Bi}, paired slope K={K_LO}->{K_HI}, "
          f"{TRIALS} interleaved trials, median [{card}]", flush=True)
    medians = {}
    for tag, p in paired_slopes(inputs).items():
        medians[tag] = med = p[len(p) // 2]
        print(f"{tag}: {med:.4f} ms/dispatch ({med * 1e3 / Bi:.4f} us/pair; paired slopes "
              f"{[f'{x:.4f}' for x in p]}) [{card}]", flush=True)
    print(", ".join(f"{tag} / production {medians[tag] / medians['production']:.3f}"
                    for tag in VARIANTS[1:]) + f" [{card}]", flush=True)
    return medians


def card_name() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("ilp_probe: needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    os.environ.pop("RSB_SW16", None)  # the production variant is the int32 kernel
    run(card_name(), tuple(x.to("cuda") for x in probe_inputs()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
