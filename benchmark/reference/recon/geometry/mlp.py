"""Positional-encoded MLPs for the SDF field and the material decoder
(PyTorch twin of ``gshell_tpu/geometry/mlp.py``).

Parameters are plain dicts / lists of tensors.  Weights are stored (in, out),
the JAX layout, and applied as ``x @ w`` so converted weights need no
transpose."""
from __future__ import annotations

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


# Rows of every MLP evaluation, for the benchmark's operation count: (kind
# "sdf" / "eikonal" / "material", rows, whether autograd records it).  The
# reference trainer clears it before a step and reads it after the forward.
evaluations = []


def _softplus100(x):
    # softplus with beta = 100, in the stable form log1p(exp(-|y|)) + max(y, 0)
    return F.softplus(100.0 * x) / 100.0


def apply_mlp(params: dict, x, cfg: MLPConfig, kind: str = "sdf"):
    evaluations.append((kind, x.shape[0], torch.is_grad_enabled()))
    emb = embed_frequencies(x, cfg.n_freq)
    h = _softplus100(emb @ params["w"][0] + params["b"][0])
    for i in range(cfg.n_hidden):
        w, b = params["w"][1 + i], params["b"][1 + i]
        if i in cfg.skip_in:
            h = torch.cat([h, emb], dim=-1)
        h = _softplus100(h @ w + b)
    return h @ params["w"][-1] + params["b"][-1]


def apply_relu_mlp(ws: list, x):
    evaluations.append(("material", x.shape[0], torch.is_grad_enabled()))
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    return h @ ws[-1]
