"""``recon.shade_ms``: host milliseconds a step inside the port's spans
``recon.shade`` (the MC walk of ``env_shade``, in the forward and again
where the backward recomputes a view) and ``recon.shade_backward`` (the
walk's backward re-walk)."""
from benchmark.program_spans import SHADE, host_ms


def read(ctx):
    ms = host_ms(ctx, SHADE)
    return ms / ctx.trace.steps if ms is not None else None
