"""rabbitsalign_tpu_torch — the short-read aligner on PyTorch and CUDA.

The single-host mapping path of `rabbitsalign_tpu`, with its extend
phase on an NVIDIA Hopper GPU: the host layer (C++ engine, index, I/O)
is the same, and the two Pallas kernels of the fused extend (the
Smith-Waterman forward pass and the traceback walk) are hand-written
CUDA kernels under `csrc/`. This package imports `torch`, never `jax`,
and does not import `rabbitsalign_tpu`: its engine is compiled from that
package's C++ source file by path (see `native/__init__.py`).
"""

__version__ = "0.1.0"


def version_string() -> str:
    return __version__
