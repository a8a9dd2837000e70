"""The plans of the Gram kernels (``fwd_plan``, ``bwd_rows_plan``,
``bwd_cols_plan``), their roofline bounds, and the backward kernels' two-level
reductions, on the CPU.

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py). What they compute is emulated here in plain PyTorch: each
chunk of a plan gives a partial, and the partials are summed in chunk order,
as a kernel's last block of a tile sums them; the forward is computed in the
kernel's direct-difference form. Those emulations are held against the plain versions
(the kernels' oracles on the card) and against the JAX reference
(``gram_pallas._bwd``, and the Pallas Gram in interpret mode).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.ops.gram_pallas import _bwd as jax_gram_bwd
from gpscore.ops.gram_pallas import _pallas_gram_scaled
from gpscore_torch.ops import _build, gram_cuda
from gpscore_torch.ops.gram_cuda import (COLS_STAGE_ROWS, COLS_TILE, FWD_COL_THREADS,
                                         FWD_COLS_PER_THREAD, ROWS_CHUNK_MIN_COLS,
                                         ROWS_MAX_STEP, ROWS_MIN_STEP, ROWS_STAGE_FLOATS,
                                         THREADS, bwd_cols_plan, bwd_rows_plan, fwd_plan,
                                         roofline)

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
    assert const("kFwdColsPerThread") == FWD_COLS_PER_THREAD
    assert 32 * const("kWarpsPerBlock") == THREADS
    # The column-thread counts and rows per thread the C entry point takes.
    entry = src[src.index("int gram_fwd("):]
    assert all(f"col_threads != {c}" in src for c in FWD_COL_THREADS)
    assert all(f"case {r}: return launch_fwd<{r}, OutT>(" in src
               for r in gram_cuda.FWD_ROWS_PER_THREAD)
    # The output types it takes, numbered as the wrapper numbers them.
    assert all(re.search(rf"case {v}:\n(.*\n)?      return static_cast<int>\(launch_fwd_rt<{t}>\(",
                         entry)
               for v, t in ((0, "float"), (1, "__nv_bfloat16"), (2, "__half")))
    assert gram_cuda.OUT_TYPES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    # The row kernel's widest step is a warp's lanes times the block's warps.
    assert ROWS_MAX_STEP == 32 * const("kWarpsPerBlock")
    rows_entry = src[src.index("int bwd_rows_entry("):]
    assert "lanes_per_row > 32 || slices > kWarpsPerBlock" in rows_entry
    # The stage layout bwd_rows_plan sizes: xps rows at an odd number of
    # float4s, g rows padded by the lanes of a row.
    assert "return vec ? (((d + 3) / 4) | 1) * 4 : (d | 1);" in src
    assert "s.g_pitch = stage_cols + (lanes < 32 ? lanes : 0);" in src


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


# ---- gram_bwd_rows: row tiles x column chunks ---------------------------------


@pytest.mark.parametrize("n,m,d,lanes,slices,n_chunks,blocks", [
    (500, 20, 8, 4, 8, 1, 63),          # the FITC K_fu: one chunk, one stage
    (20, 20, 8, 4, 8, 1, 3),            # the FITC K_uu
    (500, 500, 8, 16, 8, 1, 250),       # the exact K_ff: fills the 132 SMs with row tiles
    (9700, 20, 8, 4, 1, 1, 152),        # the 9700-row pool: 64 rows a block
    (9701, 33, 8, 4, 1, 1, 152),        # ragged rows and columns
    (40000, 20, 8, 4, 1, 1, 625),       # more rows than two blocks an SM
    (8192, 8192, 8, 4, 2, 1, 256),      # the large-n handover: 32 rows a block, 52 stages
    (9700, 20, 64, 4, 1, 1, 152),       # d > 16
    (120, 120, 1, 16, 8, 1, 60),        # the synthetic exact K_ff
    (300, 5, 1, 4, 2, 1, 10),           # the synthetic FITC K_su
    (20, 8192, 12, 32, 8, 5, 100),      # few rows, many columns: five chunks, summed in the launch
    (0, 20, 8, 4, 8, 1, 0),             # no rows: no launch
    (20, 0, 8, 1, 1, 1, 1),             # no columns: the block writes zeros
])
def test_bwd_rows_plan(n, m, d, lanes, slices, n_chunks, blocks):
    plan = bwd_rows_plan(n, m, d, H100_SMS)
    step = lanes * slices
    rows_tile = THREADS // step
    assert (plan.lanes_per_row, plan.slices, plan.n_chunks) == (lanes, slices, n_chunks)
    assert plan.row_tiles * plan.n_chunks == blocks
    assert plan.launches == (1 if n > 0 else 0)
    # Powers of two the kernel takes; a block is THREADS threads.
    assert step & (step - 1) == 0 and lanes <= 32 and slices <= THREADS // 32
    assert plan.row_tiles == -(-n // rows_tile)
    assert step <= ROWS_MAX_STEP and (m == 0 or step < 2 * max(m, ROWS_MIN_STEP))
    # The chunks cover the columns, and none of them is empty.
    assert plan.chunk_cols * (plan.n_chunks - 1) < max(m, 1) <= plan.chunk_cols * plan.n_chunks
    assert plan.chunk_cols % plan.stage_cols == 0 and plan.stage_cols % 32 == 0
    assert plan.scratch_shape == (None if n_chunks == 1 else (n_chunks, n, d + 1))
    # A stage fits its budget (a 32-column stage is the least there is).
    pad = lanes if lanes < 32 else 0
    stage_floats = plan.stage_cols * ((d + 3) // 4 | 1) * 4 + rows_tile * (plan.stage_cols + pad)
    assert stage_floats <= ROWS_STAGE_FLOATS or plan.stage_cols == 32
    # Several chunks only where the row tiles leave SMs idle.
    assert n_chunks == 1 or (plan.row_tiles < H100_SMS and plan.chunk_cols >= ROWS_CHUNK_MIN_COLS)


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 20, 8), (500, 500, 8), (9700, 20, 8),
                                   (120, 120, 1)])
def test_bwd_rows_plan_gives_the_main_path_one_chunk_of_one_stage(n, m, d):
    plan = bwd_rows_plan(n, m, d, H100_SMS)
    assert plan.n_chunks == 1 and plan.chunk_cols == plan.stage_cols >= m
    assert plan.scratch_shape is None


def test_bwd_rows_plan_fills_the_card_at_the_exact_gram():
    plan = bwd_rows_plan(500, 500, 8, H100_SMS)
    assert plan.row_tiles * plan.n_chunks >= H100_SMS


def _chunked_rows(xs, xps, sig, g, plan):
    """The row kernel's reduction in plain PyTorch. In chunk c, slice q takes
    the columns whose offset in their stage, modulo lanes * slices, falls in
    the q-th group of lanes; a chunk's slices are added in slice order, and
    the chunks' partials in chunk order, as the last block of a row tile
    adds them."""
    m = xps.shape[0]
    step = plan.lanes_per_row * plan.slices
    total = None
    for c in range(plan.n_chunks):
        cols = torch.arange(c * plan.chunk_cols, min(m, (c + 1) * plan.chunk_cols))
        local = (cols - c * plan.chunk_cols) % plan.stage_cols
        part = None
        for q in range(plan.slices):
            idx = cols[(local % step) // plan.lanes_per_row == q]
            p = gram_cuda.gram_bwd_rows_plain(xs, xps[idx], sig, g[:, idx])
            part = p if part is None else (part[0] + p[0], part[1] + p[1])
        total = part if total is None else (total[0] + part[0], total[1] + part[1])
    return total


@pytest.mark.parametrize("n,m,d,sms", [
    (500, 500, 8, H100_SMS),   # the exact K_ff: 8 slices of 16 lanes, one chunk
    (500, 20, 8, H100_SMS),    # 8 slices of 4 lanes
    (33, 257, 3, H100_SMS),    # ragged columns
    (20, 8192, 12, H100_SMS),  # five chunks of three stages
    (8, 3000, 8, H100_SMS),    # two chunks
    (2000, 20, 8, 4),          # a small card: 4 lanes, one slice, 5 trips
    (40, 300, 40, H100_SMS),   # d > 32
])
def test_sliced_row_reduction_matches_plain_and_jax(n, m, d, sms):
    """Within 1e-5 + 1e-4 * max|ref|, as chip_smoke.py holds the kernel to
    the plain version: d_xs against gram_bwd_rows_plain and against _bwd's
    d_x, and the sum of rowsum against _bwd's d_log_sig (both at zero log
    lengths, where _bwd's outputs are the scaled-input ones)."""
    rng = np.random.default_rng(n + m + d)
    xs = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    xps = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    g = rng.standard_normal((n, m)).astype(np.float32)
    sig = np.float32(np.e)
    plan = bwd_rows_plan(n, m, d, sms)
    assert plan.n_chunks == -(-m // plan.chunk_cols)
    t = [torch.tensor(a) for a in (xs, xps, sig, g)]
    d_xs, row = (a.numpy() for a in _chunked_rows(*t, plan))
    plain_d, plain_row = (a.numpy() for a in gram_cuda.gram_bwd_rows_plain(*t))
    res = (jnp.asarray(xs), jnp.asarray(xps), jnp.float32(sig), jnp.zeros(d, jnp.float32))
    jax_out = jax_gram_bwd(res, jnp.asarray(g))
    for got, ref in [(d_xs, plain_d), (row, plain_row), (d_xs, np.asarray(jax_out[0])),
                     (row.sum(), np.asarray(jax_out[2]))]:
        tol = 1e-5 + 1e-4 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol


# ---- gram_fwd: output tiles ------------------------------------------------------


def _fwd_tiles(plan):
    """(rows, columns) of K a block of the kernel takes under ``plan``."""
    return (THREADS // plan.col_threads * plan.rows_per_thread,
            FWD_COLS_PER_THREAD * plan.col_threads)


@pytest.mark.parametrize("n,m,d,col_threads,rows_per_thread,blocks", [
    (500, 20, 8, 8, 1, 16),          # the FITC K_fu: 5 of 8 column threads busy
    (20, 20, 8, 8, 1, 1),            # the FITC K_uu
    (500, 500, 8, 64, 1, 250),       # the exact K_ff
    (9700, 20, 8, 8, 1, 304),        # the 9700-row pool
    (120, 120, 1, 32, 1, 15),        # the synthetic exact K_ff
    (8192, 8192, 8, 64, 8, 8192),    # the large-n handover: 32 KB a block
    (9701, 33, 8, 16, 2, 304),       # ragged rows and columns
])
def test_fwd_plan(n, m, d, col_threads, rows_per_thread, blocks):
    plan = fwd_plan(n, m, d, H100_SMS)
    assert (plan.col_threads, plan.rows_per_thread) == (col_threads, rows_per_thread)
    assert plan.launches == 1
    rows_tile, col_tile = _fwd_tiles(plan)
    # The tiles cover K, and the narrowest column tile that covers m is taken.
    assert -(-n // rows_tile) * -(-m // col_tile) == blocks
    assert col_tile >= m or col_threads == FWD_COL_THREADS[-1]
    assert col_threads == FWD_COL_THREADS[0] or col_tile // 2 < m


@pytest.mark.parametrize("n,m", [(0, 20), (20, 0)])
def test_fwd_plan_of_an_empty_gram_launches_nothing(n, m):
    assert fwd_plan(n, m, 8, H100_SMS).launches == 0


def test_fwd_plan_gives_large_grams_big_blocks_and_small_ones_many():
    rows_tile, col_tile = _fwd_tiles(fwd_plan(8192, 8192, 8, H100_SMS))
    assert rows_tile * col_tile * 4 == 32 * 1024  # bytes written by a block
    rows_tile, col_tile = _fwd_tiles(fwd_plan(500, 500, 8, H100_SMS))
    assert -(-500 // rows_tile) * -(-500 // col_tile) >= H100_SMS


def _direct_fwd(xs, xps, sig):
    """K in the kernel's form: the direct differences, summed over k in
    ascending order."""
    d2 = torch.zeros(xs.shape[0], xps.shape[0])
    for k in range(xs.shape[1]):
        t = xs[:, k:k + 1] - xps[:, k][None, :]
        d2 = d2 + t * t
    return sig * torch.exp(-0.5 * d2)


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 20, 8), (70, 300, 3), (37, 5, 1)])
def test_tiled_forward_matches_plain_and_pallas(n, m, d):
    """The kernel's direct-difference form against the plain cross-term
    version (atol 2e-5, chip_smoke.py's FWD_ATOL) and the Pallas Gram in
    interpret mode; with xps = xs it is exactly symmetric with an exact
    diagonal. How the plan tiles K does not change an element's value; the
    tiles' coverage is test_fwd_plan's, the kernel's stores the card's."""
    rng = np.random.default_rng(7 * n + m)
    xs = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    xps = xs.copy() if n == m else rng.uniform(-1, 1, (m, d)).astype(np.float32)
    sig = np.float32(np.e)
    got = _direct_fwd(torch.tensor(xs), torch.tensor(xps), torch.tensor(sig))
    plain = gram_cuda.gram_fwd_plain(torch.tensor(xs), torch.tensor(xps), torch.tensor(sig))
    pallas = np.asarray(_pallas_gram_scaled(jnp.asarray(xs), jnp.asarray(xps), jnp.float32(sig),
                                            interpret=True))
    assert (got - plain).abs().max() <= 2e-5
    assert np.abs(got.numpy() - pallas).max() <= 2e-5
    if n == m:
        assert torch.equal(got, got.T)
        assert torch.equal(torch.diagonal(got), torch.full((n,), float(sig)))


# ---- roofline bounds -------------------------------------------------------------


@pytest.mark.parametrize("kernel,n,m,d,floats,flops", [
    # Forward: xs, xps and sig read once, K written once; 3d + 3 FLOP an element.
    ("gram_fwd", 500, 500, 8, 4000 + 4000 + 1 + 250000, 27 * 250000),
    ("gram_fwd", 500, 20, 8, 4000 + 160 + 1 + 10000, 27 * 10000),
    # Rows: also g read, d_xs and rowsum written; 6d + 6 FLOP an element.
    ("gram_bwd_rows", 500, 500, 8, 4000 + 4000 + 1 + 250000 + 4000 + 500, 54 * 250000),
    ("gram_bwd_rows", 9700, 20, 8, 77600 + 160 + 1 + 194000 + 77600 + 9700, 54 * 194000),
    # Columns: g read, d_xps written.
    ("gram_bwd_cols", 500, 20, 8, 4000 + 160 + 1 + 10000 + 160, 54 * 10000),
])
def test_roofline_counts_each_byte_once(kernel, n, m, d, floats, flops):
    r = roofline(kernel, n, m, d)
    assert (r.bytes, r.flops) == (4 * floats, flops)
    want = max(4 * floats / 3.35e12, flops / 67e12) * 1e6
    assert r.bound_us == pytest.approx(want, rel=1e-12)
    assert r.bound_by == ("bytes" if 4 * floats / 3.35e12 >= flops / 67e12 else "operations")


@pytest.mark.parametrize("kernel", ["gram_fwd", "gram_bwd_rows", "gram_bwd_cols"])
def test_roofline_reads_a_shared_x_once(kernel):
    """K(x, x) given one tensor as xs and xps (a surface's Gram) reads x
    once: at 2,500 x 20 x 20 x 1, 2,500 * 20 floats fewer, the same FLOPs."""
    both = roofline(kernel, 20, 20, 1, batch=2500)
    once = roofline(kernel, 20, 20, 1, batch=2500, shared_x=True)
    assert both.bytes - once.bytes == 4 * 2500 * 20 and once.flops == both.flops
    if kernel == "gram_fwd":
        assert once.bytes == 2500 * (4 * (20 + 1) + 4 * 400) == 4_210_000
    with pytest.raises(ValueError):
        roofline(kernel, 20, 5, 1, shared_x=True)


def test_roofline_at_the_large_n_handover():
    """8192 x 8192 x 8: 269 MB, about 80 us, by bytes, for every kernel; the
    backward's FLOPs alone would take 54 us."""
    for kernel in ("gram_fwd", "gram_bwd_rows", "gram_bwd_cols"):
        r = roofline(kernel, 8192, 8192, 8)
        assert r.bound_by == "bytes" and 80.0 < r.bound_us < 81.0
    assert roofline("gram_bwd_rows", 8192, 8192, 8).flops / 67e12 * 1e6 == pytest.approx(
        54.09, abs=0.01)
    # A kernel with no roofline raises.
    with pytest.raises(ValueError):
        roofline("gram_nope", 1, 1, 1)


def test_roofline_is_bound_by_operations_at_a_wide_input():
    # d = 64: 390 FLOP (backward) and 195 (forward) for each 4 bytes of K,
    # above the card's ridge of 67e12 / 3.35e12 = 20 FLOP a byte.
    for kernel in ("gram_fwd", "gram_bwd_rows", "gram_bwd_cols"):
        assert roofline(kernel, 4096, 4096, 64).bound_by == "operations"


# ---- the batch axis ----------------------------------------------------------


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 20, 8), (500, 500, 8), (20, 8192, 12),
                                   (9701, 33, 8), (8192, 8192, 8)])
def test_plans_at_batch_1_are_the_unbatched_plans(n, m, d):
    for plan in (fwd_plan, bwd_rows_plan, bwd_cols_plan):
        assert plan(n, m, d, H100_SMS, 1) == plan(n, m, d, H100_SMS)


def test_batched_plans_count_every_batchs_tiles():
    """At B = 16 and 500 x 20 (the multi-restart FITC K_fu) the row kernel
    takes 8 columns a trip (16 row tiles a batch, 256 blocks) and cuts no
    column chunk; alone it takes 32 (63 blocks). The column kernel keeps its
    8 row chunks (128 blocks); the forward its one row a thread."""
    alone, batched = bwd_rows_plan(500, 20, 8, H100_SMS), bwd_rows_plan(500, 20, 8, H100_SMS, 16)
    assert alone.lanes_per_row * alone.slices == 32 and alone.row_tiles == 63
    assert batched.lanes_per_row * batched.slices == 8 and batched.row_tiles == 16
    assert batched.n_chunks == 1 and batched.scratch_shape is None and batched.batch == 16
    cols = bwd_cols_plan(500, 20, 8, H100_SMS, 16)
    assert cols.n_chunks == 8 and cols.blocks == 128 and cols.scratch_shape == (8, 20, 8)
    assert fwd_plan(500, 20, 8, H100_SMS, 16).rows_per_thread == 1
    # The exact K_ff of ten replicates: every batch in one launch, no chunk.
    rows = bwd_rows_plan(500, 500, 8, H100_SMS, 10)
    assert rows.n_chunks == 1 and rows.row_tiles * 10 >= H100_SMS
    # A short-wide Gram whose tiles the batch already fills takes no column chunks.
    assert bwd_rows_plan(20, 8192, 12, H100_SMS).n_chunks > 1
    assert bwd_rows_plan(20, 8192, 12, H100_SMS, 64).n_chunks == 1
    assert all(p(500, 20, 8, H100_SMS, 0).launches == 0
               for p in (fwd_plan, bwd_rows_plan, bwd_cols_plan))


def test_roofline_of_a_batch_is_the_batch_times_one():
    for kernel in ("gram_fwd", "gram_bwd_rows", "gram_bwd_cols"):
        one, b16 = roofline(kernel, 500, 20, 8), roofline(kernel, 500, 20, 8, batch=16)
        assert b16.bytes == 16 * one.bytes and b16.flops == 16 * one.flops
        assert b16.bound_us == pytest.approx(16 * one.bound_us) and b16.bound_by == one.bound_by


@pytest.mark.parametrize("batch,chunks", [
    (0, [(0, 0)]),                    # no Grams: one empty chunk, which launches nothing
    (1, [(0, 1)]),
    (65535, [(0, 65535)]),            # the grid's z limit: still one launch
    (65536, [(0, 65535), (65535, 1)]),
    (200000, [(0, 65535), (65535, 65535), (131070, 65535), (196605, 3395)]),
])
def test_batch_chunks_cut_a_call_at_the_grids_z_limit(batch, chunks):
    """A call of more than 65,535 Grams launches in consecutive chunks that
    cover the batch once, in order; up to the limit it is one launch."""
    assert gram_cuda.MAX_BATCH == 65535
    got = gram_cuda.batch_chunks(batch)
    assert got == chunks
    assert sum(size for _, size in got) == batch
    assert all(s == prev + size for (prev, size), (s, _) in zip(got, got[1:]))


# ---- the d-chunked backward (past max_unchunked_d) ------------------------------


def _dchunk_case(cols, n, m, d, elem=4, batch=1, sms=H100_SMS):
    plan = gram_cuda.dchunk_plan(cols, n, m, d, sms, batch, elem)
    own, walk = (m, n) if cols else (n, m)
    return plan, own, walk


@pytest.mark.parametrize("elem,d", [(4, 65), (4, 90), (4, 130), (4, 385), (8, 33), (8, 40),
                                    (8, 130)])
@pytest.mark.parametrize("cols", [False, True])
@pytest.mark.parametrize("n,m,batch", [(500, 20, 1), (20, 20, 1), (500, 500, 1), (9700, 20, 1),
                                       (2048, 30720, 1), (2048, 4096, 1), (9700, 20, 3),
                                       (257, 33, 2)])
def test_dchunk_plan_tiles_the_gram(elem, d, cols, n, m, batch):
    """Every d-chunked plan covers K once: owned tiles x walked chunks of
    whole stages x feature groups, one block each; the thread tile and its
    block as the kernel derives them; the scratch of the chunk partials
    (rows: d + 1 with the row sums); shared memory as csrc/gram.cu dc_smem
    counts it, within a block's limit; the bwd_rows_plan / bwd_cols_plan
    dispatch past max_unchunked_d."""
    plan, own, walk = _dchunk_case(cols, n, m, d, elem, batch)
    want = (gram_cuda.bwd_cols_plan if cols else gram_cuda.bwd_rows_plan)(n, m, d, H100_SMS, batch,
                                                                          elem=elem)
    assert want == plan and isinstance(plan, gram_cuda.DchunkPlan)
    v = 16 // elem
    ro, ra = (gram_cuda.DC_OWN_ROWS, v) if plan.wide else (1, 1)
    assert (plan.own_tile, plan.stage) == (ro * plan.own_threads, ra * plan.walk_threads)
    assert 1 <= plan.walk_threads <= gram_cuda.DC_MAX_TX and 1 <= plan.own_threads <= 16
    assert plan.walk_threads <= 16 or plan.walk_threads % 16 == 0
    warps = -(-plan.walk_threads * plan.own_threads // 32)
    assert plan.threads == (THREADS if plan.walk_threads > 16 else 32 * warps) <= THREADS
    assert plan.tiles == -(-own // plan.own_tile)
    assert plan.chunk % plan.stage == 0
    assert plan.chunk * (plan.n_chunks - 1) < walk <= plan.chunk * plan.n_chunks
    assert plan.blocks == plan.tiles * plan.n_chunks * plan.groups * batch
    assert plan.launches == 1 and plan.batch == batch
    assert plan.groups == 1 and plan.group_width == d  # d * elem <= DC_GROUP_BYTES
    width = d if cols else d + 1
    levels = gram_cuda.dchunk_sum_groups(plan.n_chunks)
    levels = levels if levels > 1 else 0  # past 16 chunks, the sum groups' partials and tickets
    assert plan.scratch_shape == (None if plan.n_chunks == 1
                                  else (plan.n_chunks + levels, own, width))
    assert plan.tickets == plan.tiles * (1 + levels)
    assert plan.smem_bytes == gram_cuda.dchunk_smem(cols, plan.own_tile, plan.stage, d, elem)
    assert plan.smem_bytes <= gram_cuda.DC_SMEM_MAX


@pytest.mark.parametrize("elem,d", [(4, 65), (4, 90), (4, 130), (4, 385), (8, 33), (8, 40),
                                    (8, 130)])
def test_dchunk_plan_fills_the_card_where_the_work_allows(elem, d):
    """Past 64 features (32 doubles): the full pool's FITC gradient, the
    column kernel at 9700 x 20, gives every SM a block (the first d-chunked
    kernel ran 20 blocks there); the row kernel's owned tiles already do, so it cuts no
    chunk; so does the column kernel of a large-n backward block, whose owned
    side is n; the row kernel at m = 20 leaves under a third of its pass-A
    threads idle."""
    cols_pool, _, _ = _dchunk_case(True, 9700, 20, d, elem)
    assert cols_pool.blocks >= H100_SMS and cols_pool.n_chunks > 1
    rows_pool, _, _ = _dchunk_case(False, 9700, 20, d, elem)
    assert rows_pool.tiles >= H100_SMS and rows_pool.n_chunks == 1
    assert rows_pool.scratch_shape is None
    cols_block, _, _ = _dchunk_case(True, 2048, 30720, d, elem)
    assert cols_block.tiles >= H100_SMS and cols_block.n_chunks == 1
    for n in (500, 9700):
        rows, _, _ = _dchunk_case(False, n, 20, d, elem)
        assert 3 * rows.walk_threads * rows.own_threads >= 2 * rows.threads
        assert rows.stage <= 20 or rows.stage % 20 == 0


def test_dchunk_plan_forms_w_once_per_pair_up_to_2048_floats():
    """One feature group (W formed once per pair) up to DC_GROUP_BYTES of a
    row: 2048 floats, 1024 doubles; past it, groups of whole 256-byte chunks
    on the grid, W formed once per group."""
    assert gram_cuda.DC_GROUP_BYTES == 8192
    for elem, widest in ((4, 2048), (8, 1024)):
        one = gram_cuda.dchunk_plan(False, 500, 500, widest, H100_SMS, elem=elem)
        assert one.groups == 1 and one.group_width == widest
        two = gram_cuda.dchunk_plan(False, 500, 500, widest + 1, H100_SMS, elem=elem)
        assert two.groups == 2 and two.group_width % (256 // elem) == 0
        assert two.group_width < widest + 1 <= two.groups * two.group_width
    wide = gram_cuda.dchunk_plan(True, 500, 500, 4100, H100_SMS)
    assert wide.groups == 3 and wide.blocks == wide.tiles * wide.n_chunks * 3




@pytest.mark.parametrize("elem,d,merged,plain", [
    (4, 65, 2, 2), (4, 90, 2, 2), (4, 129, 2, 3), (4, 130, 2, 3), (4, 132, 2, 3),
    (4, 133, 3, 3), (4, 385, 6, 7), (4, 384, 6, 6), (8, 65, 2, 3), (8, 66, 2, 3),
    (8, 67, 3, 3), (8, 130, 4, 5)])
def test_dchunk_chunks_fold_a_short_last_chunk_where_the_block_merges(elem, d, merged, plain):
    """d in 256-byte chunks; where a block merges (a 17-vector chunk's pass-B
    items fit its threads), a remainder of up to 16 bytes past two chunks
    rides with the last full one (at most 68 floats, 34 doubles: the raw
    stage's 18 16-byte units hold it at any alignment): d = 130 takes 2 steps
    a pass, not 3. Two pass-A chunks at least remain (the g tile comes with
    the second)."""
    dc, v = 256 // elem, 16 // elem
    assert gram_cuda.dchunk_chunks(d, False, elem) == plain == -(-d // dc)
    got = gram_cuda.dchunk_chunks(d, True, elem)
    assert got == merged >= 2
    last = d - dc * (got - 1)
    assert 0 < last <= dc + v
    # The tall-skinny column plan merges; a 64-row owned tile of 256 threads does not.
    assert gram_cuda.dchunk_merges(8, True, 256, elem)
    assert not gram_cuda.dchunk_merges(64, True, 256, elem)

@pytest.mark.parametrize("elem", [4, 8])
def test_dchunk_one_pair_tiles_take_any_owned_rows(elem):
    """The one-pair thread tile takes owned tiles of any height (6 among the
    candidates at 96 x 700 x 70, whose columns' last tile of 4 starts
    aligned), and the kernel copies the g tile 16 bytes at a time only to a
    pitch of whole 16-byte vectors: a tile of 6 owned columns has a g pitch
    of 6 + 16 / elem elements, which a 16-byte cp.async may not hit."""
    cands = [p for _, p in gram_cuda.dchunk_candidates(True, 96, 700, 70, H100_SMS, elem=elem)]
    six = [p for p in cands if not p.wide and p.own_tile == 6]
    assert six and 700 % 6 == 4 and (700 - 4) % (16 // elem) == 0
    src = (_build.CSRC_DIR / "gram.cu").read_text()
    body = src[src.index("const auto stage_g_tile = "):]
    body = body[:body.index("};")]
    assert "(lay.g_pitch & (V - 1)) == 0" in body
    entry = src[src.index("int bwd_dchunk_entry("):]
    entry = entry[:entry.index("return static_cast<int>(cudaErrorInvalidValue);")]
    assert "(!wide && tx > 16)" in entry and "% 4" not in entry


def test_dchunk_plan_of_an_empty_side():
    """No owned rows: no launch. No walked rows: one chunk, whose blocks
    write zeros."""
    assert gram_cuda.dchunk_plan(False, 0, 20, 90, H100_SMS).launches == 0
    empty = gram_cuda.dchunk_plan(False, 20, 0, 90, H100_SMS)
    assert empty.launches == 1 and empty.n_chunks == 1 and empty.scratch_shape is None


def test_dchunk_plan_constants_match_the_kernel_source():
    src = (_build.CSRC_DIR / "gram.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kDcRO") == gram_cuda.DC_OWN_ROWS
    assert (const("kDcMaxTX"), const("kDcMaxTY")) == (gram_cuda.DC_MAX_TX, gram_cuda.DC_MAX_TY)
    assert const("kDcGroupBytes") == gram_cuda.DC_GROUP_BYTES
    assert const("kDcSmemMax") == gram_cuda.DC_SMEM_MAX
    # The shared memory the wrapper's plan counts is the kernel's layout.
    body = src[src.index("__host__ __device__ inline DcSmem dc_smem("):]
    body = body[:body.index("\n}\n")]
    for line in ("s.acc_pitch = round16<T>(gw);", "s.w_pitch = to + V;",
                 "s.g_pitch = cols ? to + V : ta + V;", "s.acc = to * s.acc_pitch;",
                 "s.rs = round16<T>(to);",
                 "s.wg = round16<T>(max(ta * s.w_pitch, (cols ? ta : to) * s.g_pitch));",
                 "s.stage = (to + ta) * P;", "s.raw = (to + ta) * (P + V);",
                 "s.total = s.acc + s.rs + s.wg + s.stage + s.raw;"):
        assert line in body, line
    # The chunks of d, and where a block merges a short last one.
    assert ("return merge && w > 2 * DC && (w - 1) % DC < Elem<T>::kVec ? w / DC : "
            "(w + DC - 1) / DC;") in src
    assert "const bool merge = (to + RO - 1) / RO * (P / V) <= nthr;" in src
    # The chunks' sum groups, as the plan sizes their tickets and scratch.
    assert "while (n_chunks > 16 && g * g < n_chunks) ++g;" in src
    for n_chunks, groups in ((1, 1), (16, 1), (17, 5), (38, 7), (76, 9), (81, 9), (82, 10)):
        assert gram_cuda.dchunk_sum_groups(n_chunks) == groups
    # The entry point's arguments, as _build declares them.
    entry = src[src.index("int gram_bwd_dchunk(int cols"):]
    entry = entry[:entry.index(")")]
    assert entry.count(",") + 1 == len(_build.SIGNATURES["gram_bwd_dchunk"])
    assert _build.SIGNATURES["gram_bwd_dchunk_f64"] == _build.SIGNATURES["gram_bwd_dchunk"]
    # The thread tiles and the register budget the plan's residency assumes.
    assert "bwd_dchunk_body<T, false, kBatched, kWide ? kDcRO : 1, kWide ? Elem<T>::kVec : 1>" \
        in src
    assert src.count("__launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)") == 2


def _dchunk_emulated(xs, xps, sig, g, plan, cols):
    """The d-chunked kernel's order in plain PyTorch: per walked chunk, the
    stages' terms added in stage order (a stage's walked rows in S slices,
    added together, S as a 64-feature chunk's pass B takes it: the largest
    power of two up to 32 with its items times S within the block); the
    chunks' partials added in chunk order, past 16 chunks by sum groups of
    consecutive chunks and then the groups in order, as the last blocks of
    an owned tile add them. Returns d_xps (``cols``) or (d_xs, rowsum); batched as
    the plain versions are."""
    walk = (xs if cols else xps).shape[-2]
    ro = gram_cuda.DC_OWN_ROWS if plan.wide else 1
    items = plan.own_tile // ro * (256 // xs.element_size() // (16 // xs.element_size()))
    slices = 1
    while slices < 32 and items * slices * 2 <= plan.threads:
        slices *= 2

    def term(a0, a1):
        if cols:
            return (gram_cuda.gram_bwd_cols_plain(xs[..., a0:a1, :], xps, sig, g[..., a0:a1, :]),)
        return gram_cuda.gram_bwd_rows_plain(xs, xps[..., a0:a1, :], sig, g[..., a0:a1])

    def add(u, v):
        return v if u is None else tuple(a + b for a, b in zip(u, v))

    parts = []
    for c in range(plan.n_chunks):
        part = None
        for s0 in range(c * plan.chunk, min(walk, (c + 1) * plan.chunk), plan.stage):
            w = min(plan.stage, walk - s0)
            span = -(-w // slices)
            for q in range(slices):
                lo, hi = s0 + q * span, min(s0 + w, s0 + (q + 1) * span)
                if lo < hi:
                    part = add(part, term(lo, hi))
        parts.append(part)
    per = -(-plan.n_chunks // gram_cuda.dchunk_sum_groups(plan.n_chunks))
    total = None
    for g0 in range(0, plan.n_chunks, per):  # past 16 chunks, groups of them, then the groups
        group = None
        for part in parts[g0:g0 + per]:
            group = add(group, part)
        total = add(total, group)
    return total[0] if cols else total


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,d,batch,sms", [
    (300, 70, 65, None, H100_SMS),  # 65: a chunk and one feature
    (257, 33, 130, None, 8),        # ragged sides, few SMs: several chunks
    (40, 600, 130, 2, H100_SMS),    # batched, a long walked side for the rows
    (500, 12, 385, None, H100_SMS),
    (9, 300, 385, 3, 16),
    (2400, 12, 70, None, H100_SMS),  # the columns' tall-skinny plan: sum groups of chunks
])
def test_dchunk_reduction_matches_plain_and_jax(dtype, n, m, d, batch, sms):
    """The d-chunked kernels' order of sums (stage terms, then chunk
    partials in chunk order) under the plans of both halves, against
    gram_bwd_plain and against the JAX package's _bwd at zero log lengths
    (where its d_x, d_xp are the scaled-input gradients and its d_log_sig
    the sum of the row sums), per Gram of a batch. Tolerances as the card's
    checks: fp32 1e-5 + 1e-4 * max|ref| (fp32 sums over up to 600 terms in
    other orders), fp64 against the plain version 1e-11 + 1e-11 * max|ref|
    (its cross-term form leaves ~1e-15 * |xs|^2); against _bwd the fp32 one
    in both types, since the Pallas Gram that _bwd recomputes writes K in
    float32 whatever its inputs."""
    rng = np.random.default_rng(n + m + d)
    lead = () if batch is None else (batch,)
    scale = np.sqrt(8.0 / d)  # the distances of the d = 8 case, as the smoke scales them
    xs = (rng.uniform(-1, 1, (*lead, n, d)) * scale).astype(dtype)
    xps = (rng.uniform(-1, 1, (*lead, m, d)) * scale).astype(dtype)
    g = rng.standard_normal((*lead, n, m)).astype(dtype)
    sig = np.asarray(np.e if batch is None else np.e * (1 - 0.02 * np.arange(batch)), dtype)
    elem = np.dtype(dtype).itemsize
    atol, rtol = (1e-5, 1e-4) if dtype == np.float32 else (1e-11, 1e-11)
    tx = [torch.tensor(a) for a in (xs, xps, sig, g)]
    plans = [gram_cuda.dchunk_plan(c, n, m, d, sms, batch or 1, elem) for c in (False, True)]
    assert any(p.n_chunks > 1 for p in plans) or sms == H100_SMS
    d_xs, row = (a.numpy() for a in _dchunk_emulated(*tx, plans[0], False))
    d_xps = _dchunk_emulated(*tx, plans[1], True).numpy()
    plain = [a.numpy() for a in gram_cuda.gram_bwd_plain(*tx)]
    K = gram_cuda.gram_fwd_plain(*tx).numpy()
    assert K.min() < 0.5 * K.max()  # K spans a range: W is not zero off a diagonal
    for got, ref in zip((d_xs, d_xps, row), plain):
        assert np.abs(got - ref).max() <= atol + rtol * np.abs(ref).max()
    with jax.enable_x64(dtype == np.float64):
        for b in range(batch or 1):
            pick = (lambda a: a) if batch is None else (lambda a: a[b])
            res = (jnp.asarray(pick(xs)), jnp.asarray(pick(xps)), jnp.asarray(pick(sig)),
                   jnp.zeros(d, dtype))
            jx, jxp, jsig, _ = (np.asarray(a) for a in jax_gram_bwd(res, jnp.asarray(pick(g))))
            for got, ref in ((pick(d_xs), jx), (pick(d_xps), jxp), (pick(row).sum(), jsig)):
                assert np.abs(got - ref).max() <= 1e-5 + 1e-4 * np.abs(ref).max()
