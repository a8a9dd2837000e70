"""The chunk plan of the Gram backward's column kernel (``gram_bwd_cols``) and
its two-level reduction, on the CPU.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py). What it computes is emulated here in plain PyTorch: each row
chunk of the plan gives a partial d_xps, and the partials are summed in chunk
order, as the kernel's last block of a column tile sums them. That emulation
is held against the plain version (the kernel's oracle on the card) and
against the JAX backward ``gram_pallas._bwd``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.ops.gram_pallas import _bwd as jax_gram_bwd
from gpscore_torch.ops import _build, gram_cuda
from gpscore_torch.ops.gram_cuda import COLS_STAGE_ROWS, COLS_TILE, bwd_cols_plan

H100_SMS = 132


@pytest.mark.parametrize("n,m,d,n_chunks,blocks", [
    (500, 20, 8, 8, 8),          # the main path's K_fu: 8 chunks, summed in the launch
    (20, 20, 8, 1, 1),           # the main path's K_uu: one block, no scratch
    (9700, 20, 8, 152, 152),     # the 9700-row pool's K_fu: fills the 132 SMs
    (40000, 20, 8, 157, 157),    # four double-buffered stages per block
    (9701, 33, 8, 76, 152),      # ragged rows and columns: two stages per block
    (500, 500, 8, 8, 128),       # the evaluation's K
    (0, 20, 8, 1, 1),            # no rows: one block writes zeros
])
def test_bwd_cols_plan(n, m, d, n_chunks, blocks):
    plan = bwd_cols_plan(n, m, d, H100_SMS)
    assert plan.launches == 1
    assert (plan.n_chunks, plan.blocks) == (n_chunks, blocks)
    assert plan.col_tiles == -(-m // COLS_TILE)
    assert plan.chunk_rows % COLS_STAGE_ROWS == 0
    # The chunks cover the rows, and none of them is empty.
    assert plan.chunk_rows * (plan.n_chunks - 1) < max(n, 1) <= plan.chunk_rows * plan.n_chunks
    assert plan.scratch_shape == (None if n_chunks == 1 else (n_chunks, m, d))


def test_bwd_cols_plan_fills_the_card_at_the_full_pool():
    assert bwd_cols_plan(9700, 20, 8, H100_SMS).blocks >= H100_SMS


def test_bwd_cols_plan_constants_match_the_kernel_source():
    src = (_build.CSRC_DIR / "gram.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kColsTile") == COLS_TILE
    assert const("kColsStageRows") == COLS_STAGE_ROWS
    assert const("kMaxD") == gram_cuda.MAX_D


def _two_level(xs, xps, sig, g, plan):
    """The kernel's reduction in plain PyTorch: one partial per row chunk,
    then the partials summed in chunk order."""
    r = plan.chunk_rows
    parts = [gram_cuda.gram_bwd_cols_plain(xs[c * r:(c + 1) * r], xps, sig, g[c * r:(c + 1) * r])
             for c in range(plan.n_chunks)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


@pytest.mark.parametrize("n,m,d,sms", [
    (500, 20, 8, H100_SMS),   # the main path's K_fu, 8 chunks
    (20, 20, 8, H100_SMS),    # one chunk
    (257, 33, 3, H100_SMS),   # ragged rows and two column tiles
    (2000, 20, 8, 4),         # a small card: chunks of several stages
])
def test_two_level_reduction_matches_plain_and_jax(n, m, d, sms):
    """Within 1e-5 + 1e-4 * max|ref| (fp32 sums in another order), as
    chip_smoke.py holds the kernel to the plain version."""
    rng = np.random.default_rng(n + m + d)
    xs = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    xps = xs[:m].copy() if n == m else rng.uniform(-1, 1, (m, d)).astype(np.float32)
    g = rng.standard_normal((n, m)).astype(np.float32)
    sig = np.float32(np.e)
    plan = bwd_cols_plan(n, m, d, sms)
    assert plan.n_chunks == -(-n // plan.chunk_rows)
    got = _two_level(torch.tensor(xs), torch.tensor(xps), torch.tensor(sig), torch.tensor(g),
                     plan).numpy()
    plain = gram_cuda.gram_bwd_cols_plain(torch.tensor(xs), torch.tensor(xps),
                                          torch.tensor(sig), torch.tensor(g)).numpy()
    # With zero log lengths _bwd's d_xp (gram_pallas.py:126,130) is d_xps itself.
    res = (jnp.asarray(xs), jnp.asarray(xps), jnp.float32(sig), jnp.zeros(d, jnp.float32))
    d_xp = np.asarray(jax_gram_bwd(res, jnp.asarray(g))[1])
    for ref in (plain, d_xp):
        tol = 1e-5 + 1e-4 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol
