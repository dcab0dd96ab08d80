"""``recon.shade_idle_ms``: milliseconds a step in which the device ran
nothing while the host was inside the MC shade's spans
(``recon.shade_ms``'s)."""
from benchmark.program_spans import SHADE, idle_ms


def read(ctx):
    ms = idle_ms(ctx, SHADE)
    return ms / ctx.trace.steps if ms is not None else None
