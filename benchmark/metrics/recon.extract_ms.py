"""``recon.extract_ms``: host milliseconds a step inside the port's span
``recon.extract``: the lattice fields, the G-Shell extraction, the face
compaction and the vertex normals."""
from benchmark.program_spans import host_ms


def read(ctx):
    ms = host_ms(ctx, {"recon.extract"})
    return ms / ctx.trace.steps if ms is not None else None
