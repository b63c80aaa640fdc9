"""device_results_us_per_read (us/read, program span): the engine taking
in the extend's results in phase B (`timers()["device_results_s"]`,
`set_device_results` for each batch inside the span
`rsb.phase_b#<chunk>`; thread-seconds summed over the workers) over the
window's reads. None where the program has no such timer."""


def read(ctx):
    if "device_results_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["device_results_s"] * 1e6 / ctx.reads
