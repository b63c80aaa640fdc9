"""emit_us_per_read (us/read, program span): the ordered output
(`timers()["emit_s"]`, the span `rsb.emit#<chunk>`: the reorder lock and
every `write` run under it; thread-seconds summed over the workers) over
the window's reads. None where the program has no such timer."""


def read(ctx):
    if "emit_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["emit_s"] * 1e6 / ctx.reads
