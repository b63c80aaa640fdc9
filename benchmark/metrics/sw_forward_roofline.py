"""sw_forward_roofline (%, device trace): the forward kernel's least time
on the card (benchmark/harness/roofline.py: 33 int32 operations a DP
cell at the derived int32 peak, or its bytes at the HBM peak, whichever
is longer; cells are the jobs' query x target window lengths counted
from the batches the main path dispatched) over the summed time of the
kernels named sw_forward in the trace of the window. Nothing when no
batch reached the card."""

from benchmark.harness.roofline import forward_bound_s


def read(ctx):
    if ctx.trace is None or not ctx.jobs.jobs:
        return None
    t = ctx.trace.kernel_time("sw_forward")
    if t <= 0:
        return None
    return 100.0 * forward_bound_s(ctx.jobs.jobs, ctx.jobs.cells, ctx.jobs.code_bytes) / t
