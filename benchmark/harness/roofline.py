"""The table of peaks and the work of the extend kernels, from which the
per-layer roofline shares are taken.

Frozen copies of chip_smoke.py: HBM_BYTES_PER_S and INT32_OPS_PER_S
(:294-295), OPS_PER_CELL (:300), and the arithmetic of `bound` (:518),
`forward_bound` (:524) and `traceback_bound` (:533). Two changes: the
forward's bytes count each job's true query and target lengths, not the
padded bucket, so that the work stays the same whatever shape a later
implementation pads to; the traceback's bound counts only the bytes it
must move a job (its three int32 inputs read once, its 78 packed rows
written once), since the steps of its walk are not known from the
inputs alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# DERIVED, not published: the data sheet gives no int32 rate. 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost clock (Hopper white paper), one
# operation a lane a cycle: 16.7 TOP/s.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations a DP cell of the forward (sw_cell's 30, and 3 for
# the row best; csrc/sw_forward.cu)
OPS_PER_CELL = 33
# bytes a job of the forward besides its cells' direction bytes: the
# lengths read (8) and the three int32 results written (12)
FORWARD_JOB_BYTES = 8 + 12
# bytes a job of the packed traceback: score, t_end, q_end read (12) and
# the (78, B) u8 transfer rows written (78)
TRACEBACK_JOB_BYTES = 12 + 78


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes at
    the memory peak and the operations at the int32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def forward_bound_s(jobs: int, cells: int, code_bytes: int) -> float:
    """The forward over `jobs` jobs of `cells` DP cells in all, whose
    query and target codes are `code_bytes` (read once): the cells'
    operations, against the codes, the lengths, a direction byte a cell
    and the results."""
    return bound_s(code_bytes + cells + FORWARD_JOB_BYTES * jobs, OPS_PER_CELL * cells)


def traceback_bound_s(jobs: int) -> float:
    return bound_s(TRACEBACK_JOB_BYTES * jobs, 0)
