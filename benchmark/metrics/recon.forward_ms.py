"""``recon.forward_ms``: host milliseconds a step inside the port's span
``recon.forward``: the shadow occluder, ``update_pdf`` and the tick (the
extraction, the shadow splat, every view's render, the losses)."""
from benchmark.program_spans import host_ms


def read(ctx):
    ms = host_ms(ctx, {"recon.forward"})
    return ms / ctx.trace.steps if ms is not None else None
