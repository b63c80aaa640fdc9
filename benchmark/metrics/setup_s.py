"""setup_s (s, host clock): from the process's start to the window's
start: genome, pool, index build, kernel and engine loading (or
building), the prewarm, the genome's upload and the warm-up chunks."""


def read(ctx):
    return ctx.setup_s
