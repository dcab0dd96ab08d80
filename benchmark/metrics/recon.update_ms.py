"""``recon.update_ms``: host milliseconds a step inside the port's span
``recon.update``: the gradient average (with a process group), the
non-finite zeroing, the gradient tweaks, the three Adam steps and their
schedules, the clamps and the metrics."""
from benchmark.program_spans import host_ms


def read(ctx):
    ms = host_ms(ctx, {"recon.update"})
    return ms / ctx.trace.steps if ms is not None else None
