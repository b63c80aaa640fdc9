"""index_load_s (s, host clock): the time to have the index in memory,
which the CLI's default run builds from the genome
(`StrobemerIndex.populate`, index/strobemer_index.py)."""


def read(ctx):
    return ctx.index_load_s
