"""Shared helpers for the JAX ↔ PyTorch parity tests (tests/test_torch_*.py).

* numpy ↔ torch conversion and a closeness check that reports the worst
  element;
* replay sources for :class:`gshell_tpu_torch.utils.rng.ReplayDraws` that
  re-derive the JAX package's ``jax.random`` draws from its key tree, by the
  port's draw names, so both sides compute from the same random numbers.
"""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp


def t(x, requires_grad: bool = False):
    out = torch.as_tensor(np.array(x))
    if out.dtype == torch.float64:
        out = out.float()
    return out.requires_grad_(requires_grad) if requires_grad else out


def n(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def ncdhw(a):
    """A channels-last (N, D, H, W, C) array as the port's contiguous
    (N, C, D, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def ndhwc_shape(shape):
    """An (N, C, D, H, W) shape in JAX's channels-last order."""
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


def assert_close(actual, desired, rtol, atol=0.0, what=""):
    a, d = n(actual).astype(np.float64), n(desired).astype(np.float64)
    assert a.shape == d.shape, f"{what}: shape {a.shape} != {d.shape}"
    err = np.abs(a - d)
    bad = err > atol + rtol * np.abs(d)
    if bad.any():
        i = np.unravel_index(np.argmax(err - rtol * np.abs(d)), a.shape)
        raise AssertionError(
            f"{what}: {bad.sum()} / {bad.size} elements outside rtol {rtol} atol {atol}; "
            f"worst at {i}: {a[i]} vs {d[i]}"
        )


def cosine_and_norm(a, b):
    a, b = n(a).astype(np.float64).ravel(), n(b).astype(np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    cos = float(a @ b / max(na * nb, 1e-300))
    return cos, abs(na - nb) / max(nb, 1e-300)


def _draw(kind, key, shape, lo, hi):
    if kind == "uniform":
        return np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
    if kind == "normal":
        return np.asarray(jax.random.normal(key, shape))
    return np.asarray(jax.random.randint(key, shape, lo, hi))


def shade_key_for(key, rest: str):
    """JAX key of an ``env_shade`` draw named ``rest`` (rot, pool,
    u/step{s}, c/step{s}) under the shade key."""
    k_rot, k_pool, k_loop = jax.random.split(key, 3)
    if rest == "rot":
        return k_rot
    if rest == "pool":
        return k_pool
    what, step = rest.split("/")
    ku = jax.random.fold_in(k_loop, int(step[len("step"):]))
    return ku if what == "u" else jax.random.fold_in(ku, 1)


def shade_source(key):
    """Replay source for ``env_shade(draws, ...)`` called with JAX ``key``."""
    return lambda kind, name, shape, lo, hi: _draw(kind, shade_key_for(key, name), shape, lo, hi)


def second_key_for(key, rest: str):
    """JAX key of a ``render_second_layer`` draw named ``rest`` (tangent,
    shade/...) under the view key, which JAX splits into ``k_tng, k_shade``."""
    k_tng, k_shade = jax.random.split(key)
    top, _, tail = rest.partition("/")
    return k_tng if top == "tangent" else shade_key_for(k_shade, tail)


def view_key_for(key, rest: str):
    """JAX key of a ``render_mesh`` draw named ``rest`` under view key; the
    view's second layer draws under ``second/`` from the same key."""
    k_tng, k_jit, k_shade, k_nrmjit, k_tex, k_texj = jax.random.split(key, 6)
    top, _, tail = rest.partition("/")
    if top == "second":
        return second_key_for(key, tail)
    if top == "shade":
        return shade_key_for(k_shade, tail)
    return {
        "tangent": k_tng, "jitter": k_jit, "nrm_shift": k_nrmjit, "jitter_off": k_texj,
        "tex": k_tex,  # tex/hashgrid/sel
    }[top]


def train_source(key, batch: int):
    """Replay source for ``Reconstructor.train_step(state, draws, ...)``
    called with JAX train-step ``key`` (the key tree of ``GShellGeometry.tick``)."""
    keys = jax.random.split(key, batch + 3)

    def source(kind, name, shape, lo, hi):
        top, _, rest = name.partition("/")
        if top in ("splat", "eik"):
            k = keys[batch + 1] if top == "splat" else keys[batch]
            k_face, k_uv = jax.random.split(k)
            k = k_face if rest == "face" else k_uv
        else:  # view{b}/...
            k = view_key_for(keys[int(top[len("view"):])], rest)
        return _draw(kind, k, shape, lo, hi)

    return source


def flexi_train_source(key, batch: int, splat_key):
    """Replay source for the FlexiCubes tick called with JAX tick ``key``
    (``GShellFlexiGeometry.tick`` splits it into ``batch`` view keys and an
    eikonal key) and ``splat_key``, the key a test gave the JAX
    ``splat_occupancy`` of the occluder it built for that tick."""
    keys = jax.random.split(key, batch + 1)

    def source(kind, name, shape, lo, hi):
        top, _, rest = name.partition("/")
        if top in ("splat", "eik"):
            k_face, k_uv = jax.random.split(splat_key if top == "splat" else keys[batch])
            k = k_face if rest == "face" else k_uv
        else:  # view{b}/...
            k = view_key_for(keys[int(top[len("view"):])], rest)
        return _draw(kind, k, shape, lo, hi)

    return source
