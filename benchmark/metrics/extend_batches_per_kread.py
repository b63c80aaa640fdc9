"""extend_batches_per_kread (batches/kread, program counter): extend
batches that `NativePipeline._dispatch` sent to the device in the window
(`dispatches()`, summed over workers and devices), a thousand reads."""


def read(ctx):
    return sum(ctx.dispatches) * 1000 / ctx.reads if ctx.reads else None
