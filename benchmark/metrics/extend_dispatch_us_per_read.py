"""extend_dispatch_us_per_read (us/read, program span): the extend's
host glue after phase A (`timers()["dispatch_s"]`, the span
`rsb.dispatch#<chunk>` around `NativePipeline._plan_and_dispatch`: plan,
q2 fill, pinned upload, launches, copy back enqueued; thread-seconds
summed over the workers) over the window's reads. None where the
program has no such timer."""


def read(ctx):
    if "dispatch_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["dispatch_s"] * 1e6 / ctx.reads
