"""Positional-encoded MLPs for the SDF field and the material decoder
(PyTorch twin of ``gshell_tpu/geometry/mlp.py``).

Parameters are plain dicts / lists of tensors.  Weights are stored (in, out),
the JAX layout, and applied as ``x @ w`` so converted weights need no
transpose."""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F


def embed_frequencies(x, n_freq: int):
    """(…, C) → (…, C·(2·n_freq+1)): input, then sin/cos per octave."""
    out = [x]
    for k in range(n_freq):
        f = float(2**k)
        out.append(torch.sin(f * x))
        out.append(torch.cos(f * x))
    return torch.cat(out, dim=-1)


def embed_dim(in_channels: int, n_freq: int) -> int:
    return in_channels * (2 * n_freq + 1)


class MLPConfig(NamedTuple):
    n_freq: int = 6
    d_hidden: int = 128
    d_out: int = 1
    n_hidden: int = 3
    skip_in: Sequence[int] = ()
    in_channels: int = 3


def _layer_dims(cfg: MLPConfig):
    d_emb = embed_dim(cfg.in_channels, cfg.n_freq)
    dims = [(d_emb, cfg.d_hidden)]
    for i in range(cfg.n_hidden):
        dims.append((cfg.d_hidden + (d_emb if i in cfg.skip_in else 0), cfg.d_hidden))
    return dims + [(cfg.d_hidden, cfg.d_out)]


def init_mlp(draws, cfg: MLPConfig, device) -> dict:
    """torch.nn.Linear's default init U(±1/sqrt(din)), weights (in, out)."""
    params = {"w": [], "b": []}
    for i, (din, dout) in enumerate(_layer_dims(cfg)):
        lim = 1.0 / math.sqrt(din)
        params["w"].append(draws.uniform(f"w{i}", (din, dout), -lim, lim).to(device))
        params["b"].append(draws.uniform(f"b{i}", (dout,), -lim, lim).to(device))
    return params


def _softplus100(x):
    # softplus with beta = 100, in the stable form log1p(exp(-|y|)) + max(y, 0)
    return F.softplus(100.0 * x) / 100.0


def apply_mlp(params: dict, x, cfg: MLPConfig):
    emb = embed_frequencies(x, cfg.n_freq)
    h = _softplus100(emb @ params["w"][0] + params["b"][0])
    for i in range(cfg.n_hidden):
        w, b = params["w"][1 + i], params["b"][1 + i]
        if i in cfg.skip_in:
            h = torch.cat([h, emb], dim=-1)
        h = _softplus100(h @ w + b)
    return h @ params["w"][-1] + params["b"][-1]


def init_relu_mlp(draws, dims: Sequence[int], device) -> list:
    """Bias-free ReLU MLP with Kaiming-uniform weights (in, out)."""
    ws = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        bound = math.sqrt(6.0 / din)
        ws.append(draws.uniform(f"w{i}", (din, dout), -bound, bound).to(device))
    return ws


def apply_relu_mlp(ws: list, x):
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    return h @ ws[-1]
