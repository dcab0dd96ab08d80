"""``recon.host_syncs_per_step``: runtime calls a step, inside the port's
span ``recon.step``, that wait for the device: stream, device and event
synchronizations and the blocking ``cudaMemcpy`` (``cudaMemcpyAsync``
waits only through the synchronization that follows it)."""
from benchmark.program_spans import calls

SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


def read(ctx):
    n = calls(ctx, {"recon.step"}, SYNCS.__contains__)
    return n / ctx.trace.steps if n is not None else None
