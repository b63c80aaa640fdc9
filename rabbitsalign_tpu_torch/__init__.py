"""rabbitsalign_tpu_torch — the short-read aligner on PyTorch and CUDA.

What `rabbitsalign_tpu` does, with its device code on an NVIDIA Hopper
GPU: the host layer (the C++ engine, the index, I/O, and the Python
mapper of pipeline/batched.py that the run takes under
RABBITSALIGN_TPU_NO_NATIVE) is the same, and each Pallas kernel, such as
the Smith-Waterman forward pass and the traceback walk of the extend, is
a hand-written CUDA kernel under `csrc/`. This package imports `torch`,
never `jax`, and does not import `rabbitsalign_tpu`: its engine is built
from its own copy of the C++ sources (see `native/__init__.py`).
"""

__version__ = "0.1.0"


def version_string() -> str:
    return __version__
