"""``train.update_idle_ms``: milliseconds an update in which the device ran
nothing while the host was inside the port's spans ``diffusion.update``
and ``diffusion.ema``."""
from benchmark.program_spans import UPDATE, idle_ms


def read(ctx):
    ms = idle_ms(ctx, UPDATE)
    return ms / ctx.trace.steps if ms is not None else None
