"""``flexi.extract_ms``: device milliseconds a step of the operations
launched inside the port's span ``recon.flexi_extract``: the FlexiCubes
extractor's forward (weights, surface cubes and their cases, crossings,
dual vertices, L_dev, quads, the mSDF cut, vertex normals), the lattice
MLP left out."""
from benchmark.program_spans import device_ms


def read(ctx):
    ms = device_ms(ctx, {"recon.flexi_extract"})
    return ms / ctx.trace.steps if ms is not None else None
