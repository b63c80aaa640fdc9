"""chunk_out_us_per_read (us/read, program span): the copy of a chunk's
SAM/PAF bytes out of the engine and the chunk's release after pairing
(`timers()["chunk_out_s"]`, in `NativeEngine.chunk_b_bytes` inside the
span `rsb.phase_b#<chunk>`; thread-seconds summed over the workers) over
the window's reads. None where the program has no such timer."""


def read(ctx):
    if "chunk_out_s" not in ctx.timers or not ctx.reads:
        return None
    return ctx.timers["chunk_out_s"] * 1e6 / ctx.reads
