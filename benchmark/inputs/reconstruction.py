"""Inputs of a reconstruction cell, made from the seed on the device and
handed alike to the program and to its reference.

* The parameters of a run well into its training: the SDF MLP fitted (the
  traffic's own short Adam loop, from the port's init ``U(±1/√fan_in)``)
  to the solid the skirt bounds, a bell closed at its waist and hem; the
  direct mSDF cutting that solid open at the waist and hem, with noise
  ``U(±0.05)``; zero deform; the hash tables ``U(±1e-4)``, the material MLP
  Kaiming-uniform and the light ``U(0, 1)·0.5 + 0.25`` at the port's
  initial distributions.  A state near its target keeps the mesh, and so
  the step's work, steady over the window; from the init sphere a fresh
  optimizer's first steps swing the face count between 1.2e5 and 3.3e5.
* The targets: the open wavy skirt of ``utils/synthetic_gt.py`` (a frozen
  numpy copy), centred and scaled into [−0.5, 0.5]³, seen from ``n_views``
  cameras spread evenly on a sphere (a Fibonacci lattice, the same for
  every seed), rasterized by the reference's plain binned rasterizer and
  shaded two-sided Lambert under one light, premultiplied.
* Each step's batch: ``batch`` of those views, taken in one fixed order
  (the same for every seed: which views a run has seen steers how its mesh
  grows, and so its step time), and a uniform random background per view
  drawn from the seed, as the CLI's training loop draws them (it reads no
  ``background`` key).
* Adam's moments, warm: each leaf's first moment ``first · s · N(0, 1)``
  and second ``s² · U(second)``, where ``s`` is the leaf's (or, failing
  that, its group's) RMS first gradient in the traffic's ``grad_rms``, and
  the step count ``step``.  So the first update, ``lr · (g + 9·m₀) /
  √(g² + 999·v₀)`` at count 0, depends on the gradient's size and sign
  where |g| is below ~30 s, as a fresh Adam's ``lr · sign(g)`` does not.
  At count 0 the bias correction keeps every update within about ``lr``
  however far an element's gradient lies above its leaf's RMS; at a count
  of 1000 the same moments let such elements (the mSDF's near the
  surface) step up to ~5 ``lr`` and cut the whole mesh away."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..compare import leaf_group
from ..draws import generator
from ..reference.recon.geometry.mlp import MLPConfig, _layer_dims, apply_mlp
from ..reference.recon.ops import math as gm
from ..reference.recon.ops.hashgrid import HashGridConfig
from ..reference.recon.ops.rasterize import interpolate, rasterize_tiled

MATERIAL_DIMS = (32, 32, 32, 6)  # the hash grid's features → the material MLP's hidden widths → kd, ks
LIGHT_RES = 512
MSDF_NOISE = 0.05


def skirt(nu: int = 96, nv: int = 64):
    """The skirt centred and scaled into [−0.5, 0.5]³ (as the CLI's
    ``unit_size`` does): (verts, faces)."""
    v, f = skirt_raw(nu, nv)
    lo, hi = v.min(0), v.max(0)
    return (v - (lo + hi) / 2) / np.max(hi - lo), f


def skirt_raw(nu: int = 96, nv: int = 64):
    """Open wavy skirt, a surface of revolution open at both ends (frozen
    copy of ``utils/synthetic_gt.skirt``)."""
    vs, fs = [], []
    for i in range(nv + 1):
        t = i / nv
        y = 0.9 - 1.8 * t
        r0 = 0.35 + 0.55 * t**1.3
        amp = 0.02 + 0.10 * t**2
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            r = r0 + amp * np.sin(8 * ph + 3.0 * t) + 0.015 * np.sin(17 * ph)
            vs.append((r * np.cos(ph), y, r * np.sin(ph)))
    for i in range(nv):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = (i + 1) * nu + (j + 1) % nu, (i + 1) * nu + j
            fs.append((a, b, c))
            fs.append((a, c, d))
    return np.asarray(vs, np.float32), np.asarray(fs, np.int64)


def mlp_config(flags) -> MLPConfig:
    return MLPConfig(n_freq=flags.n_freq, d_hidden=flags.d_hidden, n_hidden=flags.n_hidden,
                     skip_in=tuple(flags.skip_in))


def lattice_verts(flags, device):
    """The tet lattice's vertices, as the port's ``GShellGeometry.lattice_verts``."""
    n = flags.gshell_grid + 1
    axis = torch.linspace(-0.5, 0.5, n, dtype=torch.float32, device=device)
    axis = axis - axis.mean()
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    box = torch.tensor(flags.boxscale, dtype=torch.float32, device=device)
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * (flags.mesh_scale * box)


def skirt_frame():
    """(centre, extent) that ``skirt`` scales by: a point p of the targets'
    frame is ``p · extent + centre`` in the skirt's own."""
    v, _ = skirt_raw()
    lo, hi = v.min(0), v.max(0)
    return (lo + hi) / 2, float(np.max(hi - lo))


def bell(p, centre, extent):
    """(signed distance, in the targets' frame, to the solid the skirt bounds
    (negative inside), height in the skirt's frame) at points ``p`` (N, 3):
    the side's radial gap, capped at the waist and hem planes."""
    q = p * extent + torch.as_tensor(centre, dtype=p.dtype, device=p.device)
    t = torch.clamp((0.9 - q[:, 1]) / 1.8, 0.0, 1.0)
    phi = torch.atan2(q[:, 2], q[:, 0])
    r = (0.35 + 0.55 * t ** 1.3 + (0.02 + 0.10 * t ** 2) * torch.sin(8 * phi + 3.0 * t)
         + 0.015 * torch.sin(17 * phi))
    side = torch.sqrt(q[:, 0] ** 2 + q[:, 2] ** 2) - r
    cap = torch.abs(q[:, 1]) - 0.9
    return torch.maximum(side, cap) / extent, q[:, 1]


def make_params(flags, seed: int, device, fit_steps: int, fit_points: int):
    """→ (params_geo, params_mat, light_base) on ``device``."""
    dev = torch.device(device)
    verts = lattice_verts(flags, dev)
    n = verts.shape[0]
    cfg = mlp_config(flags)
    hg = HashGridConfig()
    dims = _layer_dims(cfg)
    sizes = ([n] + [din * dout + dout for din, dout in dims] + [hg.n_levels * hg.table_size * hg.n_features]
             + [a * b for a, b in zip(MATERIAL_DIMS[:-1], MATERIAL_DIMS[1:])] + [LIGHT_RES * LIGHT_RES * 3])
    u = torch.rand(sum(sizes), generator=generator(seed, dev, "params"), device=dev)
    parts = list(torch.split(u, sizes))
    centre, extent = skirt_frame()
    height = bell(verts, centre, extent)[1]
    msdf = torch.clamp(10.0 * (0.85 - torch.abs(height)) + (parts.pop(0) - 0.5) * (2 * MSDF_NOISE), -1.0, 1.0)
    net = {"w": [], "b": []}
    for din, dout in dims:
        lim = 1.0 / math.sqrt(din)
        wb = parts.pop(0) * (2 * lim) - lim
        net["w"].append(wb[:din * dout].reshape(din, dout).contiguous())
        net["b"].append(wb[din * dout:].contiguous())
    tables = (parts.pop(0) * 2e-4 - 1e-4).reshape(hg.n_levels, hg.table_size, hg.n_features)
    mlp = []
    for din, dout in zip(MATERIAL_DIMS[:-1], MATERIAL_DIMS[1:]):
        bound = math.sqrt(6.0 / din)
        mlp.append((parts.pop(0) * (2 * bound) - bound).reshape(din, dout))
    light = parts.pop(0).reshape(LIGHT_RES, LIGHT_RES, 3) * 0.5 + 0.25
    net = fit_bell(net, cfg, flags, seed, dev, fit_steps, fit_points, centre, extent)
    geo = {"deform": torch.zeros((n, 3), device=dev), "msdf": msdf, "sdf_net": net}
    return geo, {"tables": tables, "mlp": mlp}, light


def fit_bell(net: dict, cfg: MLPConfig, flags, seed: int, device, steps: int, points: int, centre,
             extent) -> dict:
    """The SDF MLP after ``steps`` Adam steps (lr 1e-3) towards :func:`bell`,
    on ``points`` uniform points of the lattice box a step, in float32 with
    TF32 off."""
    scale = flags.mesh_scale * torch.tensor(flags.boxscale, dtype=torch.float32, device=device)
    net = {k: [t.clone().requires_grad_(True) for t in v] for k, v in net.items()}
    opt = torch.optim.Adam(net["w"] + net["b"], lr=1e-3, eps=1e-8)
    gen = generator(seed, device, "shape_fit")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(steps):
            pts = (torch.rand((points, 3), generator=gen, device=device) - 0.5) * scale
            target = bell(pts, centre, extent)[0][:, None]
            loss = torch.mean((apply_mlp(net, pts, cfg) - target) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return {k: [t.detach() for t in v] for k, v in net.items()}


@torch.no_grad()
def render_targets(flags, seed: int, device, n_views: int, cam_radius: float, fovy_deg: float) -> dict:
    """{"mvp" (N, 4, 4), "campos" (N, 3), "img" (N, H, W, 4)} of the skirt,
    premultiplied alpha."""
    dev = torch.device(device)
    h, w = flags.train_res
    v_np, f_np = skirt()
    verts = torch.as_tensor(v_np, device=dev)
    faces = torch.as_tensor(f_np, device=dev)
    e1, e2 = verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = torch.cross(e1, e2, dim=-1)
    v_nrm = torch.zeros_like(verts).index_add_(0, faces.reshape(-1), fn.repeat_interleave(3, 0))
    v_nrm = v_nrm / torch.clamp(torch.linalg.norm(v_nrm, dim=-1, keepdim=True), min=1e-12)
    proj = gm.perspective(math.radians(fovy_deg), w / h, 0.1, 1000.0, device=dev)
    at, up = torch.zeros(3, device=dev), torch.tensor([0.0, 1.0, 0.0], device=dev)
    albedo = torch.tensor([0.62, 0.38, 0.30], device=dev)
    mvps, eyes, imgs = [], [], []
    for d in fibonacci_sphere(n_views):
        eye = torch.as_tensor(d * cam_radius, dtype=torch.float32, device=dev)
        mvp = proj @ gm.lookat(eye, at, up)
        v_clip = gm.xfm_points(verts, mvp)
        rast = rasterize_tiled(v_clip, faces, (h, w))
        nrm = interpolate(v_nrm, rast, faces)
        pos = interpolate(verts, rast, faces)
        light_dir = eye / cam_radius + torch.tensor([0.3, 0.6, 0.0], device=dev)
        light_dir = light_dir / torch.linalg.norm(light_dir)
        shade = 0.25 + 0.75 * torch.abs(torch.sum(nrm * light_dir, -1, keepdim=True))
        alpha = (rast.tri_id > 0).float()[..., None]
        color = albedo * shade * (0.9 + 0.1 * torch.cos(12.0 * pos[..., 1:2]))
        imgs.append(torch.cat([color * alpha, alpha], -1))
        mvps.append(mvp)
        eyes.append(eye)
    return {"mvp": torch.stack(mvps), "campos": torch.stack(eyes), "img": torch.stack(imgs)}


def fibonacci_sphere(n: int) -> np.ndarray:
    """``n`` unit directions spread evenly over the sphere, none within
    ~10° of the up axis (the cameras' up vector)."""
    i = np.arange(n) + 0.5
    y = 0.96 * (1.0 - 2.0 * i / n)
    r = np.sqrt(1.0 - y * y)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1)


VIEW_ORDER_SEED = 0x5EED  # the views' order: fixed, not the run's seed


def batch(targets: dict, seed: int, step: int, size: int) -> dict:
    """Step ``step``'s batch: views ``size·step`` … of the fixed order, and
    random backgrounds from the seed."""
    img_all = targets["img"]
    dev = img_all.device
    n = img_all.shape[0]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(VIEW_ORDER_SEED))
    idx = order[(torch.arange(size) + size * step) % n].to(dev)
    gen = generator(seed, dev, "batch", step)
    img = img_all[idx]
    bg = torch.rand(img.shape[:-1] + (3,), generator=gen, device=dev)
    return {"mvp": targets["mvp"][idx], "campos": targets["campos"][idx],
            "img": torch.cat([img[..., 0:3] + bg * (1.0 - img[..., 3:]), img[..., 3:]], -1),
            "background": bg}


def first_moment(name: str, shape, seed: int, device, spec: dict) -> torch.Tensor:
    """Leaf ``name``'s warm first moment (``spec``: the traffic's ``adam_moments``)."""
    s = _grad_rms(name, spec)
    return torch.randn(tuple(shape), generator=generator(seed, device, "moments", "first", name),
                       device=device) * (spec["first"] * s)


def second_moment(name: str, shape, seed: int, device, spec: dict) -> torch.Tensor:
    lo, hi = spec["second"]
    s = _grad_rms(name, spec)
    u = torch.rand(tuple(shape), generator=generator(seed, device, "moments", "second", name), device=device)
    return (u * (hi - lo) + lo) * (s * s)


def _grad_rms(name: str, spec: dict) -> float:
    rms = spec["grad_rms"]
    return float(rms[name] if name in rms else rms[leaf_group(name)])


def warm_adam(optimizers, leaves: dict, seed: int, spec: dict) -> None:
    """Give every parameter of ``optimizers`` (``torch.optim.Adam``; named by
    ``leaves``) the warm moments of its name, and the step count of
    ``spec``."""
    names = {id(t): n for n, t in leaves.items()}
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                n = names[id(p)]
                opt.state[p] = {"step": torch.tensor(float(spec["step"]), dtype=torch.float32),
                                "exp_avg": first_moment(n, p.shape, seed, p.device, spec),
                                "exp_avg_sq": second_moment(n, p.shape, seed, p.device, spec)}
