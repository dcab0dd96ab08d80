"""``train.forward_ms``: device milliseconds a micro-step of the operations
launched inside the port's span ``diffusion.forward`` (``ddpm_loss``: the
perturbation and the U-Net's forward)."""
from benchmark.harness import load_json
from benchmark.program_spans import device_ms


def read(ctx):
    ms = device_ms(ctx, {"diffusion.forward"})
    if ms is None:
        return None
    return ms / (ctx.trace.steps * load_json(ctx.found["config_path"])["num_grad_acc_steps"])
