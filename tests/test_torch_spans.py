"""The port's spans (``gshell_tpu_torch/utils/spans.py``): off without a
profiler session, on its clock and nested by their parents under one, and
the tree that one reconstruction step and one diffusion update record."""
from __future__ import annotations

import collections
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.models.unet3d import UNet3DConfig
from gshell_tpu_torch.ops import math as gm
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
from gshell_tpu_torch.utils import spans
from gshell_tpu_torch.utils.rng import TorchDraws

RES, VIEWS = 32, 2
VIEW_SPANS = ("recon.raster", "recon.material", "recon.shade", "recon.denoise")


def traced(fn):
    """``fn()`` under a CPU profiler session → (the session, the records it
    left)."""
    known = {r.id for r in spans.recorded()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, [r for r in spans.recorded() if r.id not in known]


def parents(records) -> collections.Counter:
    """(name, parent's name) → how many records."""
    by_id = {r.id: r for r in records}
    return collections.Counter((r.name, by_id[r.parent_id].name if r.parent_id in by_id else None)
                               for r in records)


def test_without_a_profiler_a_span_is_the_shared_null_context_and_records_nothing():
    before = spans.recorded()
    first, second = spans.span("t.a"), spans.span("t.b")
    assert first is second
    with first:
        with second:
            torch.ones(4).sum()
    assert spans.recorded() == before


def test_records_lie_on_the_profilers_clock_and_nest():
    def work():
        with spans.span("t.outer"):
            torch.ones(1000).sum()
            with spans.span("t.inner"):
                torch.ones(1000).cumsum(0)

    prof, records = traced(work)
    rec = {r.name: r for r in records}
    assert set(rec) == {"t.outer", "t.inner"}
    assert rec["t.inner"].parent_id == rec["t.outer"].id and rec["t.outer"].parent_id is None
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith(spans.PREFIX)}
    assert set(events) == {"gshell.t.outer", "gshell.t.inner"}
    for name, r in rec.items():
        e = events[spans.PREFIX + name]
        assert abs(r.start_ns - e.start_ns()) < 100_000, name
        assert abs(r.end_ns - (e.start_ns() + e.duration_ns())) < 100_000, name


def test_a_span_on_a_thread_with_none_open_takes_the_latest_span_open_elsewhere():
    def work():
        with spans.span("t.caller"):
            with spans.span("t.waiting"):
                worker = threading.Thread(target=lambda: spans.span("t.worker").__enter__().__exit__(None, None, None))
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()

    _, records = traced(work)
    assert parents(records) == {("t.caller", None): 1, ("t.waiting", "t.caller"): 1, ("t.worker", "t.waiting"): 1}


def tiny_reconstructor():
    """The tet grid 12 at 32², two views a step recomputed in the backward
    (``map_remat``), shadows and the denoiser on (step 1000)."""
    geo = GShellGeometry(GeometryConfig(grid_res=12, mlp=MLPConfig(n_freq=4, d_hidden=32, n_hidden=2, skip_in=(1,)),
                                        use_sdf_mlp=False, n_eikonal_samples=512, view_batch_mode="map_remat"), "cpu")
    mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                                 desired_resolution=64),
                             channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
    flags = RenderFlags(resolution=(RES, RES), n_samples=2, mc_block=2, use_denoiser=True)
    rec = Reconstructor(geo, mat, flags, TrainConfig(batch=VIEWS))
    state = rec.init_state(TorchDraws(torch.Generator().manual_seed(0)).child("init"), pretrain_steps=0)
    state.step = 1000
    proj = gm.perspective(0.8)
    eyes = [[0.4, 0.3, 2.5], [-2.5, 0.2, 0.4]]
    mvp = torch.stack([proj @ gm.lookat(e, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]) for e in eyes])
    target = {"mvp": mvp, "campos": torch.tensor(eyes), "img": torch.full((VIEWS, RES, RES, 4), 0.5),
              "background": torch.zeros((VIEWS, RES, RES, 3))}
    return rec, state, target


def test_a_reconstruction_step_records_its_phases_and_stages():
    rec, state, target = tiny_reconstructor()
    _, records = traced(lambda: rec.train_step(state, TorchDraws(torch.Generator().manual_seed(1)), target))
    want = {("recon.step", None): 1, ("recon.forward", "recon.step"): 1, ("recon.backward", "recon.step"): 1,
            ("recon.update", "recon.step"): 1, ("recon.extract", "recon.forward"): 1,
            ("recon.shadow", "recon.forward"): 1, ("recon.shade_backward", "recon.backward"): VIEWS}
    # each view renders in the forward and again, recomputed, in the backward
    want.update({(name, phase): VIEWS for name in VIEW_SPANS for phase in ("recon.forward", "recon.backward")})
    assert parents(records) == want
    step = next(r for r in records if r.name == "recon.step")
    assert all(step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns for r in records)


def test_a_diffusion_update_records_its_micro_steps_and_the_update():
    unet = UNet3DConfig(data_ch=4, base_channels=8, ch_mult=(1, 2), down_block_types=("ResBlock", "AttnResBlock"),
                        up_block_types=("AttnResBlock", "ResBlock"), num_res_blocks=1, num_res_blocks_1st_layer=1,
                        dropout=0.0)
    trainer = DiffusionTrainer(DiffusionTrainConfig(num_grad_acc_steps=2, warmup=2), unet)
    state = trainer.init_state(TorchDraws(torch.Generator().manual_seed(0)).child("init"))
    gen = torch.Generator().manual_seed(1)
    batch = {"grid": torch.randn((2, 1, 4, 8, 8, 8), generator=gen),
             "occgrid": torch.randn((2, 1, 1, 16, 16, 16), generator=gen)}
    _, records = traced(lambda: trainer.train_step(state, TorchDraws(torch.Generator().manual_seed(2)), batch))
    step = next(r for r in records if r.name == "diffusion.step")
    inside = sorted((r for r in records if r.parent_id == step.id), key=lambda r: r.start_ns)
    assert [r.name for r in inside] == ["diffusion.forward", "diffusion.backward"] * 2 + ["diffusion.update",
                                                                                           "diffusion.ema"]
    assert len(records) == len(inside) + 1 and step.parent_id is None
