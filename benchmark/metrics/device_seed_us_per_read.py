"""device_seed_us_per_read (us/read, program span): phase A's seeding on
the device, the span `rsb.seed#c` around the pipeline's `_preseed`
(`timers()["device_seed_s"]`: the codes' export, their upload, both
seeding kernels and the strobes' copy back, wall time on the worker,
summed over the workers, so thread-seconds) over the window's reads; 0
where phase A seeds on the host. None where the program has no such
timer."""


def read(ctx):
    if "device_seed_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["device_seed_s"] * 1e6 / ctx.reads
