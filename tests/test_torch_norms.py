"""rmsnorm's two sums of squares (`models/blocks.py`), on the CPU.

On the card outside an autograd graph (every serving step) `rmsnorm` sums
the squares with `sum_last_fixed`, a tree of elementwise adds fixed by the
width alone, so a data shard's rows are bitwise the whole batch's; the CPU
and training keep `mean`. Here:

- the tree's order, written out for odd widths (the carried column);
- its sum within f32 rounding of the exact (float64) sum;
- the tree's rmsnorm (the card's serving arithmetic, run here on CPU
  tensors) within one bf16 ulp of the reference's `rmsnorm` (eager JAX),
  at the widths the registry's norms take;
- the CPU `rmsnorm` still the reference's `mean` form.

The card test `test_rmsnorm_rows_independent_of_row_count_on_card`
(tests/test_torch_cuda.py) holds the card's rows bitwise across row counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as JB
from repro_torch.models import blocks as B

WIDTHS = (1, 2, 5, 7, 64, 128, 1280, 3456, 6144)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_sum_last_fixed_order_at_odd_widths():
    """Width 5: ((x0 + x2) + (x1 + x3)) + x4; width 7: ((x0 + x3) + (x1 +
    x4)) + ((x2 + x5) + x6); on values where another order rounds
    otherwise."""
    rng = np.random.default_rng(5)
    for _ in range(50):
        x = (rng.standard_normal(7) * np.exp2(rng.integers(-30, 30, 7))).astype(np.float32)
        got5 = B.sum_last_fixed(torch.from_numpy(x[:5].copy()))
        want5 = ((x[0] + x[2]) + (x[1] + x[3])) + x[4]
        assert got5.shape == (1,) and got5.item() == want5
        got7 = B.sum_last_fixed(torch.from_numpy(x.copy()))
        want7 = ((x[0] + x[3]) + (x[1] + x[4])) + ((x[2] + x[5]) + x[6])
        assert got7.item() == want7


@pytest.mark.parametrize("width", WIDTHS)
def test_sum_last_fixed_is_the_sum(width):
    g = torch.Generator().manual_seed(width)
    s = torch.randn((3, 4, width), generator=g) ** 2
    got = B.sum_last_fixed(s)
    assert got.shape == (3, 4, 1) and got.dtype == torch.float32
    exact = s.double().sum(-1, keepdim=True)
    depth = max(1, int(np.ceil(np.log2(width))))
    assert ((got.double() - exact).abs() <= depth * 2.0 ** -24 * exact).all()
    # the rows of a call are those of calls over parts of them
    parts = torch.cat([B.sum_last_fixed(s[:1]), B.sum_last_fixed(s[1:])])
    assert torch.equal(got, parts)


def _tree_rmsnorm(x, g, eps):
    """`rmsnorm`'s card serving arithmetic on any device."""
    xf = x.float()
    ms = B.sum_last_fixed(xf * xf) / xf.shape[-1]
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


@pytest.mark.parametrize("width", (64, 128, 1280, 3456, 6144))
def test_tree_rmsnorm_against_reference(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((6, width)) * 3).astype(np.float32)
    gain = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    want = JB.rmsnorm(jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(gain), 1e-5)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = _tree_rmsnorm(xt, torch.from_numpy(gain), 1e-5).float()
    # one bf16 ulp: the f32 sums differ in order only
    assert ((got - want).abs() <= want.abs() * 2.0 ** -7 + 1e-30).all()


def test_cpu_rmsnorm_keeps_the_mean():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 2, 1280), generator=g).bfloat16()
    gain = torch.rand(1280, generator=g) + 0.5
    xf = x.float()
    want = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
            * gain).bfloat16()
    with torch.no_grad():
        assert torch.equal(B.rmsnorm(x, gain), want)
