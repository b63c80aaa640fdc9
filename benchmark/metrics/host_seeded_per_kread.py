"""host_seeded_per_kread (records/kread, program counter): the records
the engine still seeded on the host (`counters()["host_seeded"]`,
summed over the workers) a thousand of the window's reads. Where phase A
seeds on the device these are its tie rows and reads over 256 bases;
1000 where the host seeds every record. None where the program counted
no seeding at all (neither this counter nor `device_seed_s`: a program
whose counter covered the device seeding alone, and did not seed
there)."""


def read(ctx):
    if "host_seeded" not in ctx.counters or not ctx.reads:
        return None
    if not ctx.counters["host_seeded"] and not ctx.timers.get("device_seed_s"):
        return None
    return ctx.counters["host_seeded"] * 1000 / ctx.reads
