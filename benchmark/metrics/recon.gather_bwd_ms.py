"""``recon.gather_bwd_ms``: device milliseconds a step of the operations
launched inside the port's span ``recon.gather_backward``: the backward of
the row gathers (``ops/gather.py``), its zeroed gradient and the hand
kernel ``csrc/gather_rows.cu``."""
from benchmark.program_spans import device_ms


def read(ctx):
    ms = device_ms(ctx, {"recon.gather_backward"})
    return ms / ctx.trace.steps if ms is not None else None
