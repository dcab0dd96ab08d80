"""``recon_step_mfu``: the operations that a reconstruction step's model
evaluations need, over the step's time, against the card's float32 peak
(the port keeps TF32 off).  Counted by the benchmark's own arithmetic from
the rows the reference's first step evaluated: the SDF MLP on the lattice
without gradient (1×), on the crossing-edge ends with gradient (3×:
forward and backward), on the eikonal samples (6×: forward, the input
gradient, and the backward of both), the material MLP on the shaded
samples (3×; the recomputation under ``map_remat`` not counted).  The
step's time is the measured window's over its steps."""
from benchmark.reference.recon.geometry.mlp import _layer_dims
from benchmark.inputs.reconstruction import MATERIAL_DIMS, mlp_config
from benchmark.reference.recon.utils.config import load_flags
from benchmark.yardstick import PEAK_FLOPS, mlp_flops

FACTOR = {("sdf", False): 1, ("sdf", True): 3, ("eikonal", True): 6, ("eikonal", False): 1,
          ("material", True): 3, ("material", False): 1}


def step_flops(config_path: str, evaluations) -> float:
    sdf = mlp_flops(_layer_dims(mlp_config(load_flags(config_path))))
    mat = mlp_flops(zip(MATERIAL_DIMS[:-1], MATERIAL_DIMS[1:]))
    return sum(FACTOR[(kind, grad)] * rows * (mat if kind == "material" else sdf)
               for kind, rows, grad in evaluations)


def read(ctx):
    evaluations = ctx.reference.get("evaluations")
    if not ctx.on_card or not evaluations or not ctx.window_steps:
        return None
    step_s = ctx.window_s / ctx.window_steps
    return 100.0 * step_flops(ctx.found["config_path"], evaluations) / step_s / PEAK_FLOPS["float32"]
