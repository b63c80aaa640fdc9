"""phase_a_us_per_read (us/read, program span): the engine's phase A
timer (`timers()["phase_a_s"]`, summed over the mapping workers, so
thread-seconds) over the window's reads."""


def read(ctx):
    return ctx.timers["phase_a_s"] * 1e6 / ctx.reads if ctx.reads else None
