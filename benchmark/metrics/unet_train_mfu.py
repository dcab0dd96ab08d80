"""``unet_train_mfu``: 3 × the U-Net's forward operations
(``yardstick.unet_forward_flops`` at the configuration's sizes) for every
sample trained in the measured window, over the window, against the
card's bf16 peak (the configuration computes under bf16 autocast)."""
from benchmark.harness import load_json
from benchmark.yardstick import PEAK_FLOPS, unet_forward_flops


def read(ctx):
    if not ctx.on_card or not ctx.window_steps:
        return None
    c = load_json(ctx.found["config_path"])
    per_sample = 3 * unet_forward_flops(c["grid_size"], c["data_ch"], c["base_channels"], c["ch_mult"],
                                        c["num_res_blocks"], c["num_res_blocks"], with_occ=c["use_occ_grid"])
    samples = ctx.window_steps * ctx.units_per_step
    return 100.0 * per_sample * samples / ctx.window_s / PEAK_FLOPS[c["compute_dtype"]]
