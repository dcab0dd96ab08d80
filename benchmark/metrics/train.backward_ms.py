"""``train.backward_ms``: device milliseconds a micro-step of the
operations launched inside the port's span ``diffusion.backward``
(``loss.backward()``)."""
from benchmark.harness import load_json
from benchmark.program_spans import device_ms


def read(ctx):
    ms = device_ms(ctx, {"diffusion.backward"})
    if ms is None:
        return None
    return ms / (ctx.trace.steps * load_json(ctx.found["config_path"])["num_grad_acc_steps"])
