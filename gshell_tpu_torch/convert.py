"""Carry the JAX package's training state into the port.

The JAX state is taken as numpy arrays (or anything ``np.asarray`` accepts):
the ``params_geo`` dict, an ``MLPTexture3DParams``-like material (``tables``
holding a ``HashGridParams``-like ``tables`` array, and ``mlp``), and
``light_base``.  MLP weights are (in, out) on both sides — the port applies
them as ``x @ w`` — so they are copied without a transpose."""
from __future__ import annotations

import numpy as np
import torch


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def params_geo_from_jax(params_geo: dict, device) -> dict:
    net = params_geo["sdf_net"]
    return {
        "deform": _t(params_geo["deform"], device),
        "msdf": _t(params_geo["msdf"], device),
        "sdf_net": {"w": [_t(w, device) for w in net["w"]], "b": [_t(b, device) for b in net["b"]]},
    }


def params_mat_from_jax(params_mat, device) -> dict:
    tables = getattr(params_mat, "tables", None)
    tables = getattr(tables, "tables", tables)
    return {"tables": _t(tables, device), "mlp": [_t(w, device) for w in params_mat.mlp]}


def state_from_jax(reconstructor, params_geo, params_mat, light_base, step: int = 0):
    """A port ``TrainState`` holding the JAX state's numbers, with fresh
    optimizers (the JAX state's own optimizer moments are not carried)."""
    dev = reconstructor.device
    return reconstructor.make_state(
        params_geo_from_jax(params_geo, dev), params_mat_from_jax(params_mat, dev),
        _t(light_base, dev), step=step,
    )
