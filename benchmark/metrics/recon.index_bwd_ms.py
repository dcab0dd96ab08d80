"""``recon.index_bwd_ms``: device milliseconds a step in the backward of
advanced-index gathers (aten's ``indexing_backward_kernel*``)."""


def read(ctx):
    ops = [o for o in ctx.trace.kernels() if "indexing_backward_kernel" in o.name]
    if not ops:
        return None
    return 1e3 * sum(o.end_ns - o.start_ns for o in ops) * 1e-9 / ctx.trace.steps
