"""``train.conv_ms``: device milliseconds a micro-step in convolutions,
forward and backward: the kernels launched by an aten operator whose name
holds ``conv`` (``tools/torch_diffusion_profile.group_of``'s rule)."""
from benchmark.harness import load_json


def read(ctx):
    s = ctx.trace.device_s_where(lambda o: "conv" in o.op)
    if not s:
        return None
    micro = ctx.trace.steps * load_json(ctx.found["config_path"])["num_grad_acc_steps"]
    return 1e3 * s / micro
