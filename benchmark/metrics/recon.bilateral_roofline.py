"""``recon.bilateral_roofline``: the bilateral stencil's launches'
least time (``yardstick.stencil_bound_s`` at the rendered size, r = 11,
6 channels when the denoiser demodulates, else 3) over their device time."""
from benchmark.reference.recon.utils.config import load_flags
from benchmark.yardstick import stencil_bound_s

RADIUS = 11


def read(ctx):
    ops = [o for o in ctx.trace.kernels() if "bilateral_kernel" in o.name]
    if not ops:
        return None
    flags = load_flags(ctx.found["config_path"])
    h, w = (n * flags.spp for n in flags.train_res)
    bound = len(ops) * stencil_bound_s(h, w, RADIUS, 6 if flags.denoiser_demodulate else 3)
    return 100.0 * bound / (sum(o.end_ns - o.start_ns for o in ops) * 1e-9)
