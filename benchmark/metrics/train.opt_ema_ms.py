"""``train.opt_ema_ms``: device milliseconds an update in AdamW and the EMA
update: the kernels launched inside the benchmark's ``bench.opt_ema`` span
around ``AdamW.step`` and ``EMA.update``."""
from benchmark.runners.diffusion import OPT_SPAN


def read(ctx):
    s = ctx.trace.device_s_where(ctx.trace.in_span(OPT_SPAN))
    return 1e3 * s / ctx.trace.steps if s else None
