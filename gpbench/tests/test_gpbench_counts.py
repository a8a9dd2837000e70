"""The frozen counts against hand counts at small shapes."""

import pytest

from gpbench.frozen.fitc_flop import fitc_step_flop
from gpbench.frozen.gram_roofline import roofline
from gpbench.frozen.kernel_kind import kernel_kind
from gpbench.frozen.peaks import H100_BYTES_PER_S, H100_FP32_FLOP_PER_S
from gpbench.frozen.step_flop import step_flop


def test_gram_fwd_counts_by_hand():
    # K of 3 x 2 on 4 inputs: reads 3*4 + 2*4 + 1 floats, writes 6; 15 FLOP an element.
    r = roofline("gram_fwd", 3, 2, 4)
    assert r.bytes == 4 * (12 + 8 + 1) + 4 * 6
    assert r.flops == 15 * 6
    assert r.bound_us == pytest.approx(max(r.bytes / H100_BYTES_PER_S,
                                           r.flops / H100_FP32_FLOP_PER_S) * 1e6)
    assert r.bound_by == "bytes"
    sq = roofline("gram_fwd", 3, 3, 4, shared_x=True, diag=True)
    assert sq.bytes == 4 * (12 + 1 + 1) + 4 * 9


def test_gram_bwd_counts_by_hand():
    rows = roofline("gram_bwd_rows", 3, 2, 4)
    # inputs 21 floats + g 6 + d_xs 12 + rowsum 3; 30 FLOP an element
    assert rows.bytes == 4 * (21 + 6 + 12 + 3) and rows.flops == 30 * 6
    cols = roofline("gram_bwd_cols", 3, 2, 4, batch=5)
    assert cols.bytes == 5 * 4 * (21 + 6 + 8) and cols.flops == 5 * 30 * 6
    assert roofline("gram_fwd", 3, 2, 4, elem=8).bytes == 8 * 21 + 8 * 6


def test_the_large_n_step_bound_is_the_sum_of_its_calls():
    from gpbench.entries.exact_steps import Run
    from gpbench.spec import load_cell

    n, b = 30720, 2048
    fwd = roofline("gram_fwd", n, n, 8, shared_x=True).bound_us
    half = roofline("gram_bwd_rows", b, n, 8).bound_us + roofline("gram_bwd_cols", b, n, 8).bound_us
    # the bounds the program's own roofline gave (PERF.md's kernel table): 1,127 us for
    # the forward, 75.46 and 75.73 for the backward halves
    assert fwd == pytest.approx(1127, rel=2e-3)
    assert half == pytest.approx(75.46 + 75.73, rel=2e-3)
    for cell, passes in (("exact30k_crps_loo", 1), ("exact30k_dss_folds", 4)):
        run = Run(load_cell(cell), 1, None)
        run.block = b
        assert run.step_gram_bound_us() == pytest.approx(fwd + passes * 15 * half)
        assert run.step_launches(2) == {"fwd": 2, "bwd_rows": 2 * passes * 15,
                                        "bwd_cols": 2 * passes * 15}


def test_step_flop_by_hand():
    assert step_flop("crps", 10) == 3000.0
    assert step_flop("nlml", 10) == 1000.0
    assert step_flop("dss", 10, fold_k=4) == 1000.0 * 3.5


def test_fitc_step_flop_by_hand():
    n, m, d = 4, 2, 1
    grams = (6 + 24) * (n * m + m * m)  # 3d + 3 forward, 2 (6d + 6) backward
    base = 2 * m ** 3 / 3 + 4 * n * m * m + 6 * n * m
    assert fitc_step_flop("crps", n, m, d) == pytest.approx(grams + 3 * (base + 4 * n * m))
    dss = base + 4 * n * m + 2 * n * m * m + 4 * m ** 3 / 3 + 4 * n * m
    assert fitc_step_flop("dss", n, m, d, fold_k=4) == pytest.approx(grams + 3 * dss)
    assert fitc_step_flop("kc", n, m, d) > fitc_step_flop("dss", n, m, d)


@pytest.mark.parametrize("name,kind", [
    ("void gram_fwd_kernel<float, 8>(...)", "gram"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("potrf_lower_L3", "solver"),
    ("trsm_left_kernel", "solver"),
    ("ncclDevKernel_AllReduce", "collective"),
    ("elementwise_kernel", "other"),
])
def test_kernel_kind(name, kind):
    assert kernel_kind(name) == kind
