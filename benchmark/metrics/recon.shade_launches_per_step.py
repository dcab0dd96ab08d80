"""``recon.shade_launches_per_step``: kernels a step launched while the
host was inside the MC shade's spans (``recon.shade_ms``'s)."""
from benchmark.program_spans import SHADE, launches


def read(ctx):
    n = launches(ctx, SHADE)
    return n / ctx.trace.steps if n is not None else None
