"""Ordered 16-bit compare probe: the CUDA kernel (csrc/int16_probe.cu)
and its plain PyTorch version.

Counterpart of rabbitsalign_tpu/ops/sw_pallas.py:probe_int16_lowering.
The Pallas probe asks whether the TPU compiler lowers an ordered int16
vector compare at all, and treats a lowering error as "no". Here the
compare always compiles; the probe asks whether the packed signed 16-bit
compare (`__vcmplts2`, two int16 lanes per 32-bit word) that a later
s16x2 forward would use gives the right answer on a seeded tile holding
-32768, 32767 and equal neighbours. A failure to build or launch the
kernel is a fault and raises; only a wrong answer reads as "no".

The result is cached as JSON under ``$RABBITSALIGN_TPU_TORCH_CACHE``,
keyed by the torch version, the CUDA version and the device name, as the
JAX probe caches per jaxlib version. Like the JAX probe, its answer is
logged and does not pick the forward's dtype (ops/sw_cuda.py:pick_dtype
does, from RSB_SW16).
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path

import numpy as np
import torch

from ..native import cache_dir
from ..utils.logger import logger

PROBE_SHAPE = (16, 128)  # the Pallas probe's tile

# launches of the CUDA kernel by int16_probe; plain-version calls are not
# counted. Updates hold _count_lock (the prewarm thread launches it).
launches = 0
_count_lock = threading.Lock()


def probe_input(seed: int = 0) -> np.ndarray:
    """A seeded (16, 128) int16 tile over the whole int16 range, with
    -32768 and 32767 in every row and runs of columns where a row equals
    the one above it (so the compare sees equal lanes)."""
    rng = np.random.RandomState(seed)
    R, C = PROBE_SHAPE
    a = rng.randint(-32768, 32768, size=(R, C)).astype(np.int16)
    a[:, 0::16] = -32768
    a[:, 1::16] = 32767
    a[0::2, 2::16] = -32768  # extreme against extreme
    a[1::2, 2::16] = 32767
    a[:, 5::8] = a[0, 5::8]  # every row equals the one above it
    return a


def int16_probe_plain(a: torch.Tensor) -> torch.Tensor:
    """where(a < roll(a, 1, 0), a, roll(a, 1, 0)), as the Pallas body
    (rabbitsalign_tpu/ops/sw_pallas.py:99-102)."""
    b = torch.roll(a, 1, 0)
    return torch.where(a < b, a, b)


def int16_probe(a: torch.Tensor) -> torch.Tensor:
    """(R, C) int16 with C even -> (R, C) int16. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    global launches
    if a.dim() != 2 or a.dtype != torch.int16 or a.shape[1] % 2:
        raise ValueError(f"an (R, C) int16 tensor with C even expected, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type == "cpu":
        return int16_probe_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"int16_probe: unsupported device {a.device}")
    from .cuda_build import load_kernels

    lib = load_kernels()
    a = a.contiguous()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.int16_probe_launch(a.data_ptr(), out.data_ptr(), a.shape[0],
                                     a.shape[1], torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"int16_probe kernel launch failed (CUDA error {err})")
    with _count_lock:
        launches += 1
    return out


def probe_cache_path(device) -> Path:
    """Where the probe's answer for this torch, CUDA and card is kept."""
    key = f"{torch.__version__}_{torch.version.cuda}_{torch.cuda.get_device_name(device)}"
    return cache_dir() / f"int16_probe_{re.sub(r'[^A-Za-z0-9.+-]+', '_', key)}.json"


def probe_int16_lowering(device) -> bool:
    """Does the packed s16x2 ordered compare give the right answer on
    this card? Read from the cache, or found by launching the kernel on
    `probe_input()` and comparing it with the plain version; the answer
    is cached and logged. Raises if the kernel does not build or launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"probe_int16_lowering needs a CUDA device, not {device}")
    path = probe_cache_path(device)
    if path.is_file():
        ok = bool(json.loads(path.read_text())["ordered_i16_compare"])
        logger.info(f"int16 probe (cached, {path}): ordered s16x2 compare "
                    f"{'exact' if ok else 'WRONG'}")
        return ok
    a = torch.from_numpy(probe_input()).to(device)
    got = int16_probe(a)
    ok = torch.equal(got, int16_probe_plain(a))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps({"ordered_i16_compare": ok}))
    tmp.replace(path)
    if ok:
        logger.info(f"int16 probe ({path}): ordered s16x2 compare exact")
    else:
        logger.warning(f"int16 probe ({path}): the ordered s16x2 compare "
                       f"disagrees with the plain version on this card")
    return ok
