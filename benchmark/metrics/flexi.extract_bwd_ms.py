"""``flexi.extract_bwd_ms``: device milliseconds a step of the operations
launched inside the port's span ``recon.flexi_extract_backward``: the
backward of what the FlexiCubes extractor computed, node by node, down to
its inputs (the lattice, the SDF, the mSDF and ``cube_weights``), its
sentinel gathers' backward among them."""
from benchmark.program_spans import device_ms


def read(ctx):
    ms = device_ms(ctx, {"recon.flexi_extract_backward"})
    return ms / ctx.trace.steps if ms is not None else None
