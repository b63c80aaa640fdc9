"""sw_traceback_roofline (%, device trace): the packed traceback's least
time on the card (its inputs read and its 78 packed rows written once a
job, at the HBM peak) over the summed time of the kernels named
sw_traceback in the trace of the window. Nothing when no batch reached
the card."""

from benchmark.harness.roofline import traceback_bound_s


def read(ctx):
    if ctx.trace is None or not ctx.jobs.jobs:
        return None
    t = ctx.trace.kernel_time("sw_traceback")
    if t <= 0:
        return None
    return 100.0 * traceback_bound_s(ctx.jobs.jobs) / t
