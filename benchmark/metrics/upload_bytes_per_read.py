"""upload_bytes_per_read (B/read, program counter): bytes of the q2
batches uploaded to the device for the extend (`counters()
["upload_bytes"]`, summed over the workers) over the window's reads.
None where the program has no such counter."""


def read(ctx):
    if "upload_bytes" not in ctx.counters or not ctx.reads:
        return None
    return ctx.counters["upload_bytes"] / ctx.reads
