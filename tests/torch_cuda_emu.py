"""Build a CUDA source of rabbitsalign_tpu_torch/csrc for the host, over
the thread-a-lane emulation of tests/torch_cuda_emu.h, into a shared
library loaded with ctypes: each `kernel<<<grid, block, smem, stream>>>(...)`
becomes `emu_launch(grid, block, smem, kernel, ...)` and the dynamic
shared memory a buffer of the launch's size. g++ (C++20, for
std::barrier) only; no CUDA."""

import ctypes
import re
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "rabbitsalign_tpu_torch" / "csrc"
HERE = Path(__file__).resolve().parent


def _top_level_split(text: str):
    """`text` cut at the commas outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _launch(m: re.Match) -> str:
    cfg = _top_level_split(m.group(2)) + ["0"]
    return f"emu_launch({cfg[0]}, {cfg[1]}, {cfg[2]}, {m.group(1)}, "


def build(name: str, out_dir: Path) -> ctypes.CDLL:
    """csrc/<name>.cu compiled for the host into out_dir, loaded."""
    return build_source(name, (CSRC / f"{name}.cu").read_text(), out_dir)


def build_source(name: str, src: str, out_dir: Path) -> ctypes.CDLL:
    """CUDA source text `src` compiled for the host into out_dir as
    lib<name>_emu.so, loaded."""
    src = src.replace("#include <cuda_runtime.h>", '#include "torch_cuda_emu.h"')
    src = re.sub(r"extern __shared__ __align__\(16\) (?:unsigned char|uint8_t) smem\[\];",
                 "unsigned char* smem = g_smem;", src)
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", _launch, src, flags=re.S)
    cpp, lib = out_dir / f"{name}_emu.cpp", out_dir / f"lib{name}_emu.so"
    cpp.write_text(src)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(HERE), "-I", str(CSRC), str(cpp), "-o", str(lib)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise RuntimeError(f"host build of {name}.cu failed:\n{res.stderr[-3000:]}")
    return ctypes.CDLL(str(lib))
