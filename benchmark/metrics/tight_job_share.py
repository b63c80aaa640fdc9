"""tight_job_share (%, program counter): the share of the extend jobs
`plan_batches` saw (`counters()["planned_jobs"]`, bucketed or not) that
it planned into the read-length profile's tight bucket
(`counters()["tight_jobs"]`: `engine_buckets(r)[0]`, (152, 256) at
r = 150 and (256, 360) at r = 250), summed over the workers. Nothing
where the program lacks either counter or planned no job."""


def read(ctx):
    planned = ctx.counters.get("planned_jobs")
    if "tight_jobs" not in ctx.counters or not planned:
        return None
    return 100.0 * ctx.counters["tight_jobs"] / planned
