"""The round-off envelope of the parity tests (``torch_parity.ulp_jitter``
and the limits derived from it), on the CPU.

``ulp_jitter`` moves every float32 result that rounds, in the forward and
in autograd's backward, toward +∞ or −∞ by one ulp of the result (√n ulp
of the sum of the terms' magnitudes for a sum of n terms), and leaves
exact results, so that the pixel coordinates, masks and ties of a render
stay what they are.  The limits derived from it lie between the limit they
replace and ``CEILING`` times it; the helpers that hold both sides to the
same branches (``branch_mask``, ``off_branches``) and the rows off the
envelope (``rows_off_round_off``) take out what they say and no more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CEILING, ENVELOPE_FACTOR, assert_close_in_envelope, branch_mask, cosine_and_norm,
                          cosine_and_norm_limits, envelope, jittered_runs, off_branches, rows_off_round_off,
                          ulp_jitter)

torch.set_num_threads(1)


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.nextafter(x, np.float32(np.inf)) - x


@pytest.mark.parametrize("direction", [1, -1])
def test_rounded_results_move_one_ulp(direction):
    """Each result that float64 shows rounded moves by one ulp of itself;
    the exact ones (x/3 where 3 divides x's significand) stay."""
    x = torch.linspace(0.1, 3.0, 101)
    ops = (torch.sqrt, lambda v: v / 3.0, torch.exp)
    for op in ops:
        plain = op(x)
        with ulp_jitter(direction):
            moved = op(x)
        rounded = (plain.double() != op(x.double())).numpy()
        assert rounded.mean() > 0.5
        step = (moved - plain).numpy() * direction
        np.testing.assert_array_equal(step[rounded], _ulp(plain.numpy())[rounded])
        np.testing.assert_array_equal(step[~rounded], 0.0)


def test_exact_results_stay():
    i = torch.arange(64, dtype=torch.float32)
    mask = (i % 3 == 0).float()
    with ulp_jitter(1):
        coords = (i + 0.5) / 64.0 * 2.0 - 1.0
        masked = mask * i
        floors = torch.floor(i / 8.0)
        roots = torch.sqrt(torch.tensor([4.0, 9.0, 0.25]))
    np.testing.assert_array_equal(coords.numpy(), ((np.arange(64) + 0.5) / 64.0 * 2.0 - 1.0).astype(np.float32))
    np.testing.assert_array_equal(masked.numpy(), (mask * i).numpy())
    np.testing.assert_array_equal(floors.numpy(), np.floor(np.arange(64) / 8.0).astype(np.float32))
    np.testing.assert_array_equal(roots.numpy(), np.float32([2.0, 3.0, 0.5]))


def test_sums_move_an_ulp_of_their_magnitude():
    """A sum of n terms that cancel moves by an ulp of Σ|terms| in the
    forward, √n of them in the backward under ``root_n``: far more than an
    ulp of the result, as another summation order may."""
    x = torch.tensor(np.random.default_rng(1).normal(size=1000), dtype=torch.float32)
    x = torch.cat([x, -x.sum(dim=0, keepdim=True)])
    plain = x.sum()
    assert plain.double() != x.double().sum()
    with ulp_jitter(1, root_n=True):
        moved = x.sum()
    ulp = float(_ulp(np.float32(torch.abs(x.double()).sum())))
    assert float(moved - plain) == pytest.approx(ulp, rel=1e-5)
    assert float(moved - plain) > 100 * float(_ulp(plain.numpy()))
    w = torch.ones(3, requires_grad=True)
    g = torch.tensor(np.random.default_rng(2).normal(size=(1001, 3)), dtype=torch.float32)

    def grad():  # dL/dw sums 1001 rows in the backward's product
        w.grad = None
        torch.sum((g @ w) ** 2).backward()
        return w.grad.clone()

    plain = grad()
    with ulp_jitter(1, root_n=True):
        moved = grad()
    with ulp_jitter(1):
        one = grad()
    assert (moved - plain).abs().max() > 10 * (one - plain).abs().max() > 0


def test_the_backward_is_jittered_and_the_graph_kept():
    w = torch.linspace(-1.0, 1.0, 48).reshape(6, 8).requires_grad_(True)
    x = torch.linspace(0.3, 2.0, 40).reshape(5, 8)

    def grad():
        w.grad = None
        torch.sum(torch.tanh(x @ w.T) ** 2).backward()
        return w.grad.clone()

    g = grad()
    for j in jittered_runs(grad):
        assert not torch.equal(j, g)
        assert cosine_and_norm(j, g)[0] > 1 - 1e-10
    assert w.grad is not None and w.grad_fn is None


def test_envelope_limits_never_tighten_a_reading():
    """The limits derived from the envelope lie between the limit they replace
    and ``CEILING`` times it."""
    rng = np.random.default_rng(0)
    got = rng.normal(size=200)
    near = [got + 1e-9 * rng.normal(size=200) for _ in range(2)]
    far = [got * (1 + 1.5e-3) + 1.4e-3 * rng.normal(size=200) for _ in range(2)]
    farther = [got + 1e-1 * rng.normal(size=200) for _ in range(2)]
    limit = (1 - 1e-6, 1e-3)
    assert cosine_and_norm_limits(got, near, limit) == limit
    lo, hi = cosine_and_norm_limits(got, far, limit)
    env = [cosine_and_norm(got, f) for f in far]
    assert lo == pytest.approx(1 - ENVELOPE_FACTOR * max(1 - c for c, _ in env)) and lo < limit[0]
    assert hi == pytest.approx(ENVELOPE_FACTOR * max(d for _, d in env)) and hi > limit[1]
    lo, hi = cosine_and_norm_limits(got, farther, limit)
    assert lo == pytest.approx(1 - CEILING * (1 - limit[0])) and hi == pytest.approx(CEILING * limit[1])
    np.testing.assert_allclose(envelope(got, far), np.max([np.abs(got - f) for f in far], axis=0))
    assert_close_in_envelope(far[0], got, [got], rtol=0.0, atol=1e-3, what="the envelope of itself covers itself")
    with pytest.raises(AssertionError):
        assert_close_in_envelope(farther[0], got, [got], rtol=0.0, atol=1e-3, what="beyond the ceiling")
    with pytest.raises(AssertionError):
        assert_close_in_envelope(got, got + 0.1, far, rtol=1e-6, what="a shift beyond the envelope")


def test_branch_mask_takes_the_pixels_a_branch_moves_and_the_clamp():
    """A pixel that a jittered run moves by more than ``PIXEL_OFF`` goes with
    all its channels; an element within 3 envelopes of 0 goes; the rest,
    moved by round-off only, stay; and more than ``MAX_OFF_BRANCH`` of the
    elements on such branches fail."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0.2, 1.0, size=(1, 16, 16, 3))
    img[0, 3, 4, 2] = -1e-6
    jit = img + 1e-7 * rng.normal(size=img.shape)
    jit[0, 7, 8, 1] += 0.05
    jit[0, 3, 4, 2] = 1e-6
    mask = branch_mask(img, [jit])
    want = np.zeros(img.shape, bool)
    want[0, 7, 8, :] = True
    want[0, 3, 4, 2] = True
    np.testing.assert_array_equal(mask, want)
    with pytest.raises(AssertionError):
        branch_mask(img, [img + 0.01])


def test_off_branches_leaves_the_masked_elements_out_on_both_sides():
    rng = np.random.default_rng(1)
    img, ref = (rng.uniform(size=(1, 4, 4, 3)).astype(np.float32) for _ in range(2))
    mask = np.zeros(img.shape, bool)
    mask[0, 1, 2] = True
    l1 = lambda a, b: (a - b).abs().mean() if isinstance(a, torch.Tensor) else jnp.mean(jnp.abs(a - b))
    x = torch.tensor(img, requires_grad=True)
    got = off_branches(l1, [mask], torch.where)(x, torch.tensor(ref))
    got.backward()
    got = got.detach()
    want, grad_j = jax.value_and_grad(off_branches(l1, [mask], jnp.where))(jnp.asarray(img), jnp.asarray(ref))
    kept = np.where(mask, 0.0, np.abs(img - ref)).mean()
    assert float(got) == pytest.approx(kept, rel=1e-6) and float(want) == pytest.approx(kept, rel=1e-6)
    assert not x.grad.numpy()[mask].any() and not np.asarray(grad_j)[mask].any()
    assert x.grad.numpy()[~mask].all() and np.asarray(grad_j)[~mask].all()


def test_rows_off_round_off_leave_out_the_fewest_rows_that_carry_the_envelope():
    rng = np.random.default_rng(2)
    got = rng.normal(size=(400, 3))
    jit = got + 1e-9 * rng.normal(size=got.shape)
    jit[17] += 0.5
    jit[250] += 0.1
    keep = rows_off_round_off(got, [jit], (0.999999, 1e-4))
    assert (~keep).sum() == 2 and not keep[17] and not keep[250]
    assert rows_off_round_off(got, [got], (0.999999, 1e-4)).all()
    with pytest.raises(AssertionError):
        rows_off_round_off(got, [got + 0.1 * rng.normal(size=got.shape)], (0.999999, 1e-4))


@pytest.mark.parametrize("name", ["sqrt", "exp", "log", "sin", "cos"])
def test_cpu_elementary_functions_lie_within_an_ulp_and_a_half(name):
    """torch's and XLA's float32 elementary functions on the CPU lie within
    1.5 ulp of the exact value (float64), though often not on the correctly
    rounded one (on an "AMD EPYC" host torch's ``sqrt`` misses it on 17 % of
    these inputs, XLA's ``log`` on 12 % and reaches 1.03 ulp): two such
    implementations differ by up to about three ulp per operation where
    ``ulp_jitter`` moves one, which ``ENVELOPE_FACTOR`` covers."""
    x = (np.abs(np.random.default_rng(0).normal(size=20000)) * (1 if name == "sqrt" else 3) + 1e-3).astype(np.float32)
    exact = getattr(np, name)(x.astype(np.float64))
    for got in (getattr(torch, name)(torch.from_numpy(x)).numpy(), np.asarray(getattr(jnp, name)(jnp.asarray(x)))):
        ulp = np.maximum(_ulp(exact.astype(np.float32)), _ulp(got)).astype(np.float64)
        assert (np.abs(got.astype(np.float64) - exact) <= 1.5 * ulp).all(), np.max(np.abs(got - exact) / ulp)
