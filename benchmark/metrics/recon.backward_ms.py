"""``recon.backward_ms``: host milliseconds a step inside the port's span
``recon.backward`` (``total.backward()``: the views recomputed under
``map_remat``, the MC re-walk, the gather backward)."""
from benchmark.program_spans import host_ms


def read(ctx):
    ms = host_ms(ctx, {"recon.backward"})
    return ms / ctx.trace.steps if ms is not None else None
