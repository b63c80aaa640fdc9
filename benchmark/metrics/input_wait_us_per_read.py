"""input_wait_us_per_read (us/read, program span): the mapping workers'
wait for a parsed chunk (`timers()["input_wait_s"]`, the span
`rsb.input_wait` around the worker's `in_q.get`; thread-seconds summed
over the workers) over the window's reads. None where the program has
no such timer."""


def read(ctx):
    if "input_wait_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["input_wait_s"] * 1e6 / ctx.reads
