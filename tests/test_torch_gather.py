"""``ops/gather.py`` on the CPU: ``gather_rows(src, idx)`` and its plain
backward against aten's ``src[idx]``, bit for bit, and the counters of rows
seen and scattered.  The hand kernel it launches on a CUDA tensor is held
to aten on the card in ``tests/test_torch_cuda.py``.

aten's CPU backward of ``src[idx]`` is ``index_put_(accumulate=True)``,
which splits its work across threads above its grain size (32,768
elements), where its own result changes from run to run; the long cases
run on one thread, where both add in index order."""
import contextlib
import math
import zlib

import pytest
import torch

from gshell_tpu_torch.ops.gather import gather_rows, gather_stats, scatter_rows_plain
from gshell_tpu_torch.utils.kernels import kernel_launches

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}


def bits(t):
    return t.contiguous().view(BITS[t.dtype])


def both(src, idx, g):
    """(aten's value, aten's gradient), (gather_rows's value, its gradient)."""
    out = []
    for fn in (lambda s: s[idx], lambda s: gather_rows(s, idx)):
        s = src.detach().clone().requires_grad_()
        y = fn(s)
        (grad,) = torch.autograd.grad(y, s, g)
        out.append((y.detach(), grad))
    return out


def grads_of(pattern: str, shape, width: int, dtype, gen):
    """A gradient of ``shape`` whose rows (``width`` trailing elements
    each) follow ``pattern``."""
    g = (torch.randn(shape, generator=gen, dtype=torch.float64) * 3).to(dtype)
    n = g.numel() // width
    if n == 0:
        return g
    rows = g.view(n, width)
    pick = torch.rand(n, generator=gen) < 0.5
    if pattern == "zeros":
        rows[pick] = 0.0
    elif pattern == "signed_zero":
        rows[pick] = -0.0
        rows[torch.rand(n, generator=gen) < 0.3] = 0.0
    elif pattern == "nonfinite":
        rows[pick] = 0.0
        if n > 2:
            rows[1, 0] = float("nan")
            rows[2, -1] = float("inf")
            rows[n - 1] = float("-inf")
    return g


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pattern", ["random", "one_row", "zeros", "signed_zero", "nonfinite"])
@pytest.mark.parametrize("idx_shape, row", [((), (3,)), ((0,), (3,)), ((7,), ()), ((3, 5), (11,)),
                                             ((2, 3, 4), (2, 2)), ((0, 3), (4,))])
def test_gather_rows_equals_aten_bit_for_bit(idx_shape, row, pattern, dtype):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(zlib.crc32(repr((idx_shape, row, pattern, dtype)).encode()))
    n = 9
    src = torch.randn((n, *row), generator=gen, dtype=torch.float64).to(dt)
    if pattern == "one_row":
        idx = torch.full(idx_shape, 4, dtype=torch.int64)
    else:
        idx = torch.randint(0, n, idx_shape, generator=gen)
    g = grads_of("random" if pattern == "one_row" else pattern, (*idx_shape, *row), math.prod(row), dt, gen)
    (ya, ga_), (yb, gb) = both(src, idx, g)
    assert yb.shape == ya.shape and gb.shape == ga_.shape == src.shape
    assert torch.equal(bits(yb), bits(ya))
    assert torch.equal(bits(gb), bits(ga_))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pattern", ["random", "zeros", "nonfinite"])
def test_plain_scatter_equals_the_index_backward(pattern, dtype):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(7)
    n, m, c = 40, 3000, 5
    idx = torch.randint(0, n, (m,), generator=gen)
    idx[: m // 3] = n - 1  # a sentinel run
    g = grads_of(pattern, (m, c), c, dt, gen)
    src = torch.zeros((n, c), dtype=dt, requires_grad=True)
    (want,) = torch.autograd.grad(src[idx], src, g)
    assert torch.equal(bits(scatter_rows_plain(g, idx, n)), bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_the_light_lookup_as_one_row_gather_equals_its_two_index_gather(dtype):
    """The MC shade's ``lp[ly, lx]`` as ``gather_rows`` of the (H·W, 4) rows
    at ``ly·W + lx``."""
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    hh, ww, k, p = 16, 32, 4, 600
    lp = torch.rand((hh, ww, 4), generator=gen).to(dt).requires_grad_()
    ly, lx = torch.randint(0, hh, (k, p), generator=gen), torch.randint(0, ww, (k, p), generator=gen)
    ly[:, :200], lx[:, :200] = 0, 0
    g = grads_of("zeros", (k, p, 4), 4, dt, gen)
    want = lp[ly, lx]
    got = gather_rows(lp.reshape(hh * ww, -1), ly * ww + lx)
    assert torch.equal(bits(got), bits(want))
    (gw,) = torch.autograd.grad(want, lp, g)
    (gg,) = torch.autograd.grad(got, lp, g)
    assert torch.equal(bits(gg), bits(gw))


@pytest.mark.parametrize("live_run", [False, True])
def test_a_sentinel_run_of_a_million_rows(live_run):
    """Every padded slot reads the sentinel row N: its gradient rows are zero
    (as the extraction masks them), or not (the heaviest run the backward
    can meet)."""
    gen = torch.Generator().manual_seed(11)
    n, m, c = 5000, 1_000_000, 3
    idx = torch.full((m,), n, dtype=torch.int64)
    real = 200_000
    idx[:real] = torch.randint(0, n, (real,), generator=gen)
    g = torch.randn((m, c), generator=gen)
    if not live_run:
        g[real:] = 0.0
    src = torch.randn((n + 1, c), generator=gen)
    with one_thread():
        (ya, want), (yb, got) = both(src, idx, g)
    assert torch.equal(yb, ya)
    assert torch.equal(bits(got), bits(want))


def test_gather_stats_counts_rows_seen_and_scattered():
    gen = torch.Generator().manual_seed(5)
    src = torch.randn((20, 3), generator=gen, requires_grad=True)
    idx = torch.randint(0, 20, (6, 50), generator=gen)
    g = torch.randn((6, 50, 3), generator=gen)
    g[:, :30] = 0.0
    g[0, 0, 1] = -0.0
    g[1, 0, 2] = float("nan")  # a live row
    g[2, 5] = -0.0  # a zero row
    before = gather_stats()
    torch.autograd.grad(gather_rows(src, idx), src, g)
    after = gather_stats()
    assert after["rows_seen"] - before["rows_seen"] == 300
    assert after["rows_scattered"] - before["rows_scattered"] == 6 * 20 + 1
    assert after["launches"] == before["launches"] == kernel_launches()["gather_rows"]  # no kernel on the CPU


def test_a_double_backward_is_refused():
    """No path differentiates the gathers' backward again; asking for it
    raises instead of treating the scatter as a constant."""
    x = torch.randn((6, 2), dtype=torch.float64, requires_grad=True)
    y = gather_rows(x, torch.tensor([[1, 1, 5], [0, 1, 1]]))
    (gx,) = torch.autograd.grad((y ** 3).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), x)


def test_an_int32_index_gathers_as_int64():
    src = torch.arange(12.0).reshape(6, 2).requires_grad_()
    idx = torch.tensor([5, 0, 5], dtype=torch.int32)
    (a, ga_), (b, gb) = both(src, idx.long(), torch.ones(3, 2))
    y = gather_rows(src, idx)
    assert torch.equal(y, a)
    assert torch.equal(torch.autograd.grad(y, src, torch.ones(3, 2))[0], ga_)
