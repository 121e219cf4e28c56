"""setup_s: process start to the first timed call (host clock): imports, the
pool written, weights made on the device and loaded, the cell's bucket
shape warmed up by one call."""


def read(ctx):
    return ctx.setup_s
