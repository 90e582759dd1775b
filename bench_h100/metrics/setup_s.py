"""setup_s: process start to the first timed request (s): imports, the
kernel library (built on a checkout's first run), the log, the map,
staging, start-up and warm-up."""


def read(ctx):
    return ctx.setup_s
