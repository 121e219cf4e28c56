"""device_idle_share (device): the share of the traced window in which no
kernel, copy or set runs on the card, from the profiler's timeline (the
union of device intervals, so overlapping kernels count once), averaged
over the cards of the job."""


def read(ctx):
    tr = ctx.record.trace
    busy = [b for b in ctx.busy_s_ranks if b is not None]
    if not tr or not busy or tr["window_s"] <= 0:
        return None
    return 1.0 - (sum(busy) / len(busy)) / tr["window_s"]
