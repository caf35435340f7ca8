"""device_idle_share: the share of the traced window in which no
operation ran on the card, in percent: 1 - the union of the profiler's
device activities over the window."""


def read(ctx):
    if ctx.tracer is None or not len(ctx.tracer.device[0]):
        return None
    return 100.0 * (1.0 - ctx.tracer.busy_s / ctx.tracer.window_s)
