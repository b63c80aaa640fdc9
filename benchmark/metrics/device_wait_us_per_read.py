"""device_wait_us_per_read (us/read, program span): the workers' wait on
the extend's copy-back events in `finish_chunk`
(`timers()["device_wait_s"]`, the span `rsb.device_wait#<chunk>`;
thread-seconds summed over the workers) over the window's reads. None
where the program has no such timer."""


def read(ctx):
    if "device_wait_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["device_wait_s"] * 1e6 / ctx.reads
