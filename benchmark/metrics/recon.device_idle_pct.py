"""``recon.device_idle_pct``: the share of the traced window in which no
device operation ran."""


def read(ctx):
    return ctx.trace.idle_pct() if ctx.trace.device_ops else None
