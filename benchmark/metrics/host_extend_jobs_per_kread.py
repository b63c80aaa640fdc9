"""host_extend_jobs_per_kread (jobs/kread, program counter): gapped
extend jobs resolved by the engine's host SSW in phase B instead of the
device (`counters()`: `small_to_host`, in batches under the engine's
MIN_DEVICE_JOBS; `unbucketed`, no bucket fits them; `fallbacks`, device
results rejected; summed over the workers), a thousand reads. None where
the program has no such counters."""

KEYS = ("small_to_host", "unbucketed", "fallbacks")


def read(ctx):
    if not all(k in ctx.counters for k in KEYS) or not ctx.reads:
        return None
    return sum(ctx.counters[k] for k in KEYS) * 1000 / ctx.reads
