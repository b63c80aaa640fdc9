"""host_walked_per_kread (records/kread, program counter): the records
whose run walk the engine did on the host index
(`counters()["host_walked"]`, summed over the workers) a thousand of the
window's reads. Where phase A walks the runs on the device these are its
tie rows and reads over 256 bases, which the engine seeds itself, and
the records whose kept hits overflowed their room; 1000 where the host
walks every record. None where the program has no such counter."""


def read(ctx):
    if "host_walked" not in ctx.counters or not ctx.reads:
        return None
    return ctx.counters["host_walked"] * 1000 / ctx.reads
