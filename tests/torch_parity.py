"""Shared helpers for the JAX ↔ PyTorch parity tests (tests/test_torch_*.py).

* numpy ↔ torch conversion and a closeness check that reports the worst
  element;
* replay sources for :class:`gshell_tpu_torch.utils.rng.ReplayDraws` that
  re-derive the JAX package's ``jax.random`` draws from its key tree, by the
  port's draw names, so both sides compute from the same random numbers;
* round-off: the same inputs at a stage where the two frameworks round
  differently (``clip_from_jax``), the port's round-off envelope
  (``ulp_jitter``), the image elements whose branch round-off decides
  (``branch_mask``), held out of both sides' losses, and the limits a
  comparison may derive from the envelope (``cosine_and_norm_limits``).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
        "tex_shift": k_jit,  # a Texture2D material's smoothness tap shift
    }[top]


def band_key_for(view_key, rest: str, n_band: int):
    """(key, name) of a draw under a view's key: a banded render's cell
    draws under ``band{b}/`` from the view key's ``b``-th of ``n_band``
    splits, as JAX's banded ticks split it."""
    if rest.startswith("band"):
        band, _, rest = rest.partition("/")
        return jax.random.split(view_key, n_band)[int(band[len("band"):])], rest
    return view_key, rest


def train_source(key, batch: int, n_band: int = 1):
    """Replay source for ``Reconstructor.train_step(state, draws, ...)``
    called with JAX train-step ``key`` (the key tree of ``GShellGeometry.tick``;
    ``n_band`` bands under a banded render)."""
    keys = jax.random.split(key, batch + 3)

    def source(kind, name, shape, lo, hi):
        top, _, rest = name.partition("/")
        if top in ("splat", "eik"):
            k = keys[batch + 1] if top == "splat" else keys[batch]
            k_face, k_uv = jax.random.split(k)
            k = k_face if rest == "face" else k_uv
        else:  # view{b}/...
            k = view_key_for(*band_key_for(keys[int(top[len("view"):])], rest, n_band))
        return _draw(kind, k, shape, lo, hi)

    return source


def flexi_train_source(key, batch: int, splat_key, n_band: int = 1):
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
            k = view_key_for(*band_key_for(keys[int(top[len("view"):])], rest, n_band))
        return _draw(kind, k, shape, lo, hi)

    return source


# ---------------------------------------------------------------- round-off


def clip_from_jax(points, matrix):
    """The port's ``xfm_points`` with JAX's values: the forward is what
    ``gshell_tpu.ops.math.xfm_points`` computes from the same points and
    matrix, the derivatives are the port's.  The two frameworks sum the
    four products of each clip coordinate in another order, so a quarter
    of the coordinates differ by an ulp, which the edge functions of the
    antialiasing amplify (``tests/test_torch_render_options.py``); a test
    that patches this into ``gshell_tpu_torch.render.render`` holds both
    sides to the same clip positions."""
    from gshell_tpu.ops.math import xfm_points as j_xfm_points
    from gshell_tpu_torch.ops.math import xfm_points

    got = xfm_points(points, matrix)
    want = np.asarray(j_xfm_points(jnp.asarray(n(points)), jnp.asarray(n(matrix))))
    return got + (torch.as_tensor(want.copy()) - got).detach()


# The ATen operators (by name; the forward's and autograd's backward's)
# whose float32 results round: arithmetic and the elementary functions (a
# CPU math library's, within 1.5 ulp of the exact value, but not the same
# ulp on every CPU nor the same as XLA's) ...
ROUNDING = frozenset("""
    add sub rsub mul div reciprocal addcmul addcdiv lerp pow square hypot
    sqrt rsqrt exp exp2 expm1 log log2 log10 log1p sin cos tan tanh sigmoid softplus atan atan2 erf
    sigmoid_backward tanh_backward softplus_backward
""".split())
# ... and the sums, which another summation order (or a fused multiply-add)
# rounds differently by up to about √n ulp of the sum of the n terms'
# magnitudes, however much the terms cancel: contractions, reductions and
# the scatter-adds of the gathers' backward.
SUMS = frozenset("""
    mm bmm addmm baddbmm mv addmv dot sum mean cumsum index_add index_put scatter_add _unsafe_index_put
""".split())


def _wide(x, magnitude: bool = False):
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.float32:
            return x
        x = x.double()
        return x.abs() if magnitude else x
    if isinstance(x, (list, tuple)):
        return type(x)(_wide(y, magnitude) for y in x)
    return x


def _terms(name: str, args, out) -> int:
    """How many terms each result of a :data:`SUMS` operator adds up."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("mm", "bmm", "mv"):
        return tensors[0].shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return tensors[1].shape[-1] + 1
    if name == "cumsum":
        return tensors[0].shape[args[1]] if tensors[0].dim() else 1
    return max(1, max(t.numel() for t in tensors) // max(out.numel(), 1))


class ulp_jitter(TorchDispatchMode):
    """Within the block, every float32 CPU result that rounds, of the forward
    and of autograd's backward alike, moves toward +∞ (``direction`` 1) or
    −∞ (−1): a :data:`ROUNDING` operator's by one ulp of the result, a
    :data:`SUMS` operator's by one ulp of the same sum of its n terms'
    magnitudes, in the backward by √n of them with ``root_n`` (the
    backward's sums run over pixels and samples whose terms cancel).  A
    result rounds where the same operator in float64 gives another value;
    exact results (pixel coordinates, masks, integers held as floats) stay,
    as do non-finite results and in-place operators.  Two
    implementations that round differently (two frameworks, two CPUs, two
    math libraries, a fused multiply-add or not, another summation order)
    differ by such amounts, so the distance between a computation and
    itself under this mode is how far the computation carries round-off:
    its round-off envelope, from which the parity tests derive their
    limits.  Each direction moves equal inputs to equal outputs, so ties
    between equal computations stay ties."""

    def __init__(self, direction: int, root_n: bool = False):
        super().__init__()
        self.toward = 1.0 if direction > 0 else -1.0
        self.root_n = root_n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if not ((name in ROUNDING or name in SUMS) and isinstance(out, torch.Tensor)
                and out.dtype == torch.float32 and out.device.type == "cpu" and out.numel()):
            return out
        wide = func(*_wide(args), **_wide(kwargs))
        if name in SUMS:
            scale = func(*_wide(args, True), **_wide(kwargs, True)).float().abs()
            backward = torch._C._current_autograd_node() is not None
            spread = math.sqrt(_terms(name, args, out)) if self.root_n and backward else 1.0
        else:
            scale, spread = out.abs(), 1.0
        step = (torch.nextafter(scale, torch.full_like(scale, np.inf)) - scale) * spread
        moved = out + self.toward * step
        return torch.where(torch.isfinite(step) & (out.double() != wide), moved, out)


# A port-vs-JAX distance may be this many times the round-off envelope:
# each side's elementary functions lie within 1.5 ulp of the exact value
# (``tests/test_torch_round_off.py``), so the two sides differ by up to
# about three ulp per operation where ``ulp_jitter`` moves one.
ENVELOPE_FACTOR = 3.0
# A limit derived from the envelope is never looser than this many times the
# limit it replaces, so that no comparison becomes vacuous where the port's
# round-off envelope is large.
CEILING = 10.0
# The envelope is the largest distance over these runs of ``ulp_jitter``
# (direction, root_n): a round-off that flips a sample in one run may not in
# another, so one run alone under-reads the spread.
# The forward's values need only the first two (``root_n`` moves the
# backward's sums).
ENVELOPE_RUNS = ((1, False), (-1, False), (1, True), (-1, True))


def jittered_runs(run, runs=ENVELOPE_RUNS):
    """``run()`` under :class:`ulp_jitter` for each of ``runs``."""
    out = []
    for direction, root_n in runs:
        with ulp_jitter(direction, root_n):
            out.append(run())
    return out


def envelope(got, jittered):
    """Elementwise round-off envelope of ``got``: its largest distance from
    the ``jittered`` runs of the same computation."""
    g = n(got).astype(np.float64)
    return np.max([np.abs(g - n(j).astype(np.float64)) for j in jittered], axis=0)


def assert_close_in_envelope(actual, desired, jittered, rtol, atol=0.0, what=""):
    """:func:`assert_close` with ``ENVELOPE_FACTOR`` times the port's
    elementwise round-off envelope added to ``atol``, at most ``CEILING``
    times the tolerance it widens."""
    d = np.abs(n(desired).astype(np.float64))
    extra = np.minimum(ENVELOPE_FACTOR * envelope(actual, jittered), (CEILING - 1.0) * (atol + rtol * d))
    assert_close(actual, desired, rtol, atol + extra, what)


def cosine_and_norm_limits(got, jittered, limits):
    """(cosine ≥, relative norm difference ≤) for ``got`` against JAX: the
    looser of ``limits`` and ``ENVELOPE_FACTOR`` times the port's round-off
    envelope (the largest distance of ``got`` from its ``jittered`` runs;
    the factor scales 1 − cosine), and never looser than ``CEILING`` times
    ``limits``."""
    env = [cosine_and_norm(got, j) for j in jittered]
    lo = min(limits[0], 1.0 - ENVELOPE_FACTOR * max(1.0 - c for c, _ in env))
    hi = max(limits[1], ENVELOPE_FACTOR * max(d for _, d in env))
    return max(lo, 1.0 - CEILING * (1.0 - limits[0])), min(hi, CEILING * limits[1])


def assert_cosine_and_norm(got, want, jittered, limits, what=""):
    """``got`` against ``want`` by cosine and relative norm difference at
    ``limits``, or with ``jittered`` runs of the port at
    :func:`cosine_and_norm_limits`."""
    cos, dn = cosine_and_norm(got, want)
    lo, hi = cosine_and_norm_limits(got, jittered, limits) if jittered else limits
    assert cos >= lo and dn <= hi, f"{what}: cosine {cos} (≥ {lo}), relative norm difference {dn} (≤ {hi})"


# ------------------------------------------------ the same branches on both sides

# A pixel whose value the port's round-off moves by more than this took
# another branch (a Monte-Carlo sample, a texel, a clamp) in a jittered run:
# round-off alone moves a pixel by about 1e-6, a branch by a share of its
# value.  It is the difference at which ``tests/test_torch_second_layer.py``
# counts a pixel off.
PIXEL_OFF = 1e-3
# At most this share of an image's elements may be on such branches.
MAX_OFF_BRANCH = 0.01


def branch_mask(plain, jittered):
    """The elements of an image (B, H, W, C) whose branch the port's
    round-off decides: every channel of a pixel that one of the
    ``jittered`` runs moves by more than ``PIXEL_OFF``, and each element
    within ``ENVELOPE_FACTOR`` envelopes of 0, where an image loss clamps.
    Held exactly: at most ``MAX_OFF_BRANCH`` of the elements."""
    plain = n(plain).astype(np.float64)
    env = envelope(plain, jittered)
    off = np.broadcast_to(env.max(-1, keepdims=True) > PIXEL_OFF, plain.shape)
    mask = off | ((env > 0) & (np.abs(plain) <= ENVELOPE_FACTOR * env))
    assert mask.mean() <= MAX_OFF_BRANCH, (int(mask.sum()), mask.size)
    return mask


def rows_off_round_off(got, jittered, limits):
    """Which rows of ``got`` (N, k) to compare at ``limits`` (cosine ≥,
    relative norm difference ≤): all but the rows with the largest
    round-off envelope (their distance from the ``jittered`` runs), left
    out fewest first until ``ENVELOPE_FACTOR`` times the envelope of the
    rest is within ``limits``.  Held exactly: at most ``MAX_OFF_BRANCH`` of
    the rows go."""
    g = n(got).astype(np.float64)
    js = [n(j).astype(np.float64) for j in jittered]
    order = np.argsort(np.max([np.linalg.norm(g - j, axis=1) for j in js], axis=0))[::-1]
    keep = np.ones(len(g), bool)
    for k in range(int(MAX_OFF_BRANCH * len(g)) + 1):
        keep[order[:k]] = False
        env = [cosine_and_norm(g[keep], j[keep]) for j in js]
        if (1.0 - ENVELOPE_FACTOR * max(1.0 - c for c, _ in env) >= limits[0]
                and ENVELOPE_FACTOR * max(d for _, d in env) <= limits[1]):
            return keep
    raise AssertionError(f"more than {MAX_OFF_BRANCH} of {len(g)} rows carry the round-off envelope")


def assert_rows_off_round_off(got, want, jittered, limits, what=""):
    """``got`` against ``want`` (N, k) by cosine and relative norm difference
    at ``limits`` over the rows of :func:`rows_off_round_off`."""
    keep = rows_off_round_off(got, jittered, limits)
    assert_cosine_and_norm(n(got)[keep], n(want)[keep], [], limits, what=f"{what} ({int((~keep).sum())} rows out)")


def recording(loss_fn, seen: list):
    """``loss_fn(img, ref)`` that appends each ``img`` it is given to ``seen``."""
    def loss(img, ref):
        seen.append(n(img).copy())
        return loss_fn(img, ref)
    return loss


def off_branches(loss_fn, masks, where):
    """``loss_fn(img, ref)`` with the elements of ``masks[k]`` (for its k-th
    call) taken from ``ref``, so that they add nothing to the loss nor to
    its gradient: ``where`` is ``jnp.where`` or ``torch.where``."""
    calls = itertools.cycle(masks)

    def loss(img, ref):
        mask = next(calls)
        return loss_fn(where(mask if where is jnp.where else torch.as_tensor(mask), ref, img), ref)
    return loss


def branch_masks(run, loss_fn):
    """One :func:`branch_mask` for each call of the image loss ``loss_fn``
    in ``run(loss_fn)``, from the port's plain run and its two forward
    envelope runs."""
    seen = [[] for _ in range(3)]
    run(recording(loss_fn, seen[0]))
    for k, (direction, root_n) in enumerate(ENVELOPE_RUNS[:2]):
        with ulp_jitter(direction, root_n):
            run(recording(loss_fn, seen[1 + k]))
    return [branch_mask(img, [s[i] for s in seen[1:]]) for i, img in enumerate(seen[0])]
