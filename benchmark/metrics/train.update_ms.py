"""``train.update_ms``: device milliseconds an update of the operations
launched inside the port's spans ``diffusion.update`` (``AdamW.step``) and
``diffusion.ema`` (``EMA.update``)."""
from benchmark.program_spans import UPDATE, device_ms


def read(ctx):
    ms = device_ms(ctx, UPDATE)
    return ms / ctx.trace.steps if ms is not None else None
