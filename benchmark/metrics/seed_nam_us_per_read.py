"""seed_nam_us_per_read (us/read, program span): the seeding and NAM
part of phase A (`timers()["seed_nam_s"]`, thread-seconds) over the
window's reads."""


def read(ctx):
    return ctx.timers["seed_nam_s"] * 1e6 / ctx.reads if ctx.reads else None
