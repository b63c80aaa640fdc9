"""reads_per_s (reads/s, host clock): reads whose records reached the
`write` callback (a pair counts 2), over the wall time from the window's
start to the last record after the drain."""


def read(ctx):
    return ctx.window.n_reads / ctx.window.seconds
