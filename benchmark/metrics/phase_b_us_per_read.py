"""phase_b_us_per_read (us/read, program span): the engine's phase B
timer (`timers()["phase_b_s"]`: device results in, pairing, SAM out;
thread-seconds) over the window's reads."""


def read(ctx):
    return ctx.timers["phase_b_s"] * 1e6 / ctx.reads if ctx.reads else None
