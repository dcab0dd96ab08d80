"""Carry the JAX package's training state into the port.

The JAX state is taken as numpy arrays (or anything ``np.asarray`` accepts):
the ``params_geo`` dict, an ``MLPTexture3DParams``-like material (``tables``
holding a ``HashGridParams``-like ``tables`` array, and ``mlp``), and
``light_base``.  MLP weights are (in, out) on both sides — the port applies
them as ``x @ w`` — so they are copied without a transpose.  Texture2D
materials carry over mip level by mip level."""
from __future__ import annotations

import numpy as np
import torch

from .render.material import TextureMaterial
from .render.texture import Texture2D


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def params_geo_from_jax(params_geo: dict, device) -> dict:
    """Geometry parameters: ``deform``, FlexiCubes' ``cube_weights`` where
    the state has them, then a direct ``sdf`` or an ``sdf_net`` MLP, and a
    direct ``msdf`` or an ``msdf_net`` MLP, as the JAX state holds them."""
    out = {"deform": _t(params_geo["deform"], device)}
    if "cube_weights" in params_geo:
        out["cube_weights"] = _t(params_geo["cube_weights"], device)
    for name in ("sdf", "msdf"):
        if name in params_geo:
            out[name] = _t(params_geo[name], device)
        else:
            net = params_geo[f"{name}_net"]
            out[f"{name}_net"] = {"w": [_t(w, device) for w in net["w"]],
                                  "b": [_t(b, device) for b in net["b"]]}
    return out


def unet_params_from_flax(params: dict) -> dict:
    """A flax ``UNet3D`` parameter tree → the port's ``UNet3D`` state dict.
    Module names carry over (``CheckpointResBlock_k``, the rematerialized
    name, becomes ``ResBlock_k``); a conv kernel (kd, kh, kw, in, out)
    becomes (out, in, kd, kh, kw), the transposed occupancy head's is
    flipped on its spatial axes and laid out (in, out, kd, kh, kw), a dense
    kernel (in, out) becomes (out, in)."""
    out = {}

    def walk(node, path):
        for name, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + [name.replace("CheckpointResBlock_", "ResBlock_")])
                continue
            a = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                name = "weight"
                if a.ndim == 5 and path[-1].startswith("ConvTranspose"):
                    a = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
                elif a.ndim == 5:
                    a = a.transpose(4, 3, 0, 1, 2)
                else:
                    a = a.T
            out[".".join(path + [name])] = torch.from_numpy(np.array(a, order="C"))

    walk(params, [])
    return out


def params_mat_from_jax(params_mat, device) -> dict:
    tables = getattr(params_mat, "tables", None)
    tables = getattr(tables, "tables", tables)
    return {"tables": _t(tables, device), "mlp": [_t(w, device) for w in params_mat.mlp]}


def texture_from_jax(tex, device):
    """A JAX ``Texture2D`` (its ``mips``, numpy or JAX arrays) as the port's,
    level for level."""
    return Texture2D(mips=tuple(_t(m, device) for m in tex.mips))


def texture_material_from_jax(mat: dict, device):
    """A JAX Texture2D material dict (``kd``, ``ks``, optional ``normal``)
    as the port's ``TextureMaterial``."""
    normal = texture_from_jax(mat["normal"], device) if "normal" in mat else None
    return TextureMaterial(kd=texture_from_jax(mat["kd"], device), ks=texture_from_jax(mat["ks"], device),
                           normal=normal)


def state_from_jax(reconstructor, params_geo, params_mat, light_base, step: int = 0):
    """A port ``TrainState`` holding the JAX state's numbers, with fresh
    optimizers (the JAX state's own optimizer moments are not carried)."""
    dev = reconstructor.device
    return reconstructor.make_state(
        params_geo_from_jax(params_geo, dev), params_mat_from_jax(params_mat, dev),
        _t(light_base, dev), step=step,
    )
