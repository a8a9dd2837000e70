"""The port's CUDA kernels on the card. Every test here needs a CUDA device and
skips without one; on a machine with a card and no JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets JAX up). Nothing here imports JAX.
"""

import numpy as np
import pytest
import torch

from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import SCHEDULES, fit_gd, make_objective
from gpscore_torch.ops import _build, gram_cuda, linalg
from gpscore_torch.ops.kernels import gram
from gpscore_torch.utils.params import init_rand_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gpscore_torch kernels have no CPU mode")
    return torch.device("cuda", 0)


def _scaled(seed, n, m, d, dev):
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.uniform(-1, 1, (n, d)).astype(np.float32), device=dev)
    xps = torch.tensor(rng.uniform(-1, 1, (m, d)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((n, m)).astype(np.float32), device=dev)
    return xs, xps, torch.tensor(1.7, device=dev), g


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 20, 8), (257, 33, 1), (1031, 70, 17),
                                   (64, 9, 64), (9700, 1, 8), (9701, 33, 8), (40000, 20, 8),
                                   (9700, 20, 64), (500, 500, 16), (1031, 70, 12),
                                   (20, 8192, 12), (8, 3000, 8), (4099, 1031, 8)])
def test_gram_kernels_match_plain(dev, n, m, d):
    """Forward (atol 2e-5: the plain cross-term form's cancellation) and
    backward (1e-5 + 1e-4 * max|ref|: fp32 sums in another order), at every
    DMAX bucket of the backward (d = 12 and 16 with 16-byte xps rows in the
    row kernel), and at row-kernel plans of several stages (500 x 500 x 16,
    4099 x 1031) and several chunks (20 x 8192, 8 x 3000)."""
    xs, xps, sig, g = _scaled(n + m + d, n, m, d, dev)
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= 2e-5
    for a, b in zip(gram_cuda.gram_bwd_cuda(xs, xps, sig, g),
                    gram_cuda.gram_bwd_plain(xs, xps, sig, g)):
        assert (a - b).abs().max() <= 1e-5 + 1e-4 * b.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m,d", [(None, 500, 500, 65), (None, 9700, 20, 130),
                                     (None, 500, 20, 8), (None, 20, 8192, 33),
                                     (3, 300, 70, 65), (3, 20, 20, 8),
                                     (None, 9700, 20, 385), (None, 2048, 4096, 90),
                                     (None, 500, 500, 40), (3, 9700, 20, 130)])
def test_wide_d_and_float64_kernels_match_plain(dev, dtype, B, n, m, d):
    """The d-chunked builds (d past 64 floats / 32 doubles) and the float64
    builds against their plain versions, values and both gradients, unbatched
    and batched (the tall-skinny column plans' chunk sums, the large-n block's
    wide tiles, float64's d-chunked build at d = 40); a second call is bitwise
    the first. fp32 at the tolerances above; fp64 at 1e-12 (K) and 1e-11 +
    1e-11 * max|ref| (the backward). The inputs are scaled by sqrt(8 / d),
    so K spans a range and W is not zero off the diagonal."""
    gen = torch.Generator(device=dev).manual_seed(n + m + d)
    lead = () if B is None else (B,)
    xs, xps = ((torch.rand((*lead, rows, d), generator=gen, device=dev, dtype=dtype) * 2 - 1)
               * (8 / d) ** 0.5 for rows in (n, m))
    g = torch.randn((*lead, n, m), generator=gen, device=dev, dtype=dtype)
    sig = torch.tensor(1.7, device=dev, dtype=dtype)
    f_tol, b_rtol, b_atol = (2e-5, 1e-4, 1e-5) if dtype == torch.float32 else (1e-12, 1e-11, 1e-11)
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert K.dtype == dtype
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= f_tol
    assert K.min() < 0.5 * K.max()
    got = gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
    for a, b in zip(got, gram_cuda.gram_bwd_plain(xs, xps, sig, g)):
        assert a.dtype == dtype
        assert (a - b).abs().max() <= b_atol + b_rtol * b.abs().max()
    assert torch.equal(K, gram_cuda.gram_fwd_cuda(xs, xps, sig))
    assert all(torch.equal(a, b) for a, b in zip(got, gram_cuda.gram_bwd_cuda(xs, xps, sig, g)))



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,d", [(500, 20, 90), (257, 33, 130), (96, 700, 70)])
def test_every_dchunk_tiling_matches_plain(dev, dtype, n, m, d):
    """Every candidate tiling of the d-chunked kernels (both thread tiles,
    every TX x TY the plans may pick, chunked or not), not only the one the
    plan takes, against the plain version at the tolerances above; one
    launch each, a second bitwise the first."""
    gen = torch.Generator(device=dev).manual_seed(n + d)
    xs, xps = ((torch.rand((rows, d), generator=gen, device=dev, dtype=dtype) * 2 - 1)
               * (8 / d) ** 0.5 for rows in (n, m))
    g = torch.randn((n, m), generator=gen, device=dev, dtype=dtype)
    sig = torch.tensor(1.7, device=dev, dtype=dtype)
    atol, rtol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-11, 1e-11)
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = gram_cuda.gram_bwd_plain(xs, xps, sig, g)
    for cols, ref in ((False, (want[0], want[2])), (True, (want[1],))):
        for _, plan in gram_cuda.dchunk_candidates(cols, n, m, d, sms, elem=xs.element_size()):
            outs = []
            for _ in range(2):
                out = torch.empty_like(ref[0])
                row = None if cols else torch.empty_like(ref[1])
                gram_cuda.reset_launches()
                gram_cuda._launch_plan(lib, torch.cuda.current_stream().cuda_stream, [plan],
                                       (xs, xps, sig, g, out, row), [0] * 6, n, m, d)
                assert sum(gram_cuda.LAUNCHES.values()) == 1
                outs.append((out,) if cols else (out, row))
            for a, b, w in zip(*outs, ref):
                assert torch.equal(a, b), plan
                assert (a - w).abs().max() <= atol + rtol * w.abs().max(), plan


def _wide_inputs(seed, B, n, m, d, dev, dtype, square=False):
    """xs, xps uniform in [-1, 1] scaled by sqrt(8 / d) (K spans a range at
    any d), sig [B] (or one value), xps = xs when ``square``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = () if B is None else (B,)
    xs = (torch.rand((*lead, n, d), generator=gen, device=dev, dtype=dtype) * 2 - 1) * (8 / d) ** 0.5
    xps = xs if square else ((torch.rand((*lead, m, d), generator=gen, device=dev, dtype=dtype)
                              * 2 - 1) * (8 / d) ** 0.5)
    sig = (torch.tensor(1.7, device=dev, dtype=dtype) if B is None
           else 1.7 - 0.1 * torch.arange(B, device=dev, dtype=dtype))
    return xs, xps, sig


def _fwd_dchunk_call(plan, xs, xps, sig, out_dtype=None, diag_add=None):
    """One launch of the d-chunked forward under ``plan``, unbatched."""
    n, d = xs.shape
    m = xps.shape[0]
    out = torch.empty((n, m), dtype=out_dtype or xs.dtype, device=xs.device)
    in_kernel = diag_add is not None and out.dtype not in gram_cuda.DTYPES
    gram_cuda._launch_plan(_build.load_library(), torch.cuda.current_stream().cuda_stream, [plan],
                           (xs, xps, sig, diag_add.data_ptr() if in_kernel else None, out),
                           [0] * 4, n, m, d, gram_cuda.OUT_TYPES.get(out.dtype, 0))
    if diag_add is not None and not in_kernel:
        out.diagonal().add_(diag_add)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,d", [(500, 20, 90), (257, 33, 130), (96, 700, 65), (300, 300, 65),
                                   (1031, 520, 90)])
def test_every_fwd_dchunk_tile_matches_plain(dev, dtype, n, m, d):
    """Every candidate tiling of the d-chunked forward (every thread tile,
    TX x TY and stage width the plan may pick, one stage or several) against
    the plain version: fp32 at 2e-5 (the plain cross-term form's
    cancellation), fp64 at 1e-12; one launch each, a second bitwise the
    first; at a square shape (xps = xs) K exactly symmetric with an exact
    diagonal; and the plan's own tiling through gram_fwd_cuda."""
    square = n == m
    xs, xps, sig = _wide_inputs(n + m + d, None, n, m, d, dev, dtype, square)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    want = gram_cuda.gram_fwd_plain(xs, xps, sig)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cands = gram_cuda.fwd_dchunk_candidates(n, m, d, sms, elem=xs.element_size())
    assert {p.tile for _, p in cands} == set(range(len(gram_cuda.FD_TILES)))
    for _, plan in cands:
        gram_cuda.reset_launches()
        K = _fwd_dchunk_call(plan, xs, xps, sig)
        assert gram_cuda.LAUNCHES["fwd_dchunk"] == 1
        assert torch.equal(K, _fwd_dchunk_call(plan, xs, xps, sig)), plan
        assert (K - want).abs().max() <= tol, plan
        if square:
            assert torch.equal(K, K.T), plan
            assert torch.equal(torch.diagonal(K), sig.expand(n)), plan
    gram_cuda.reset_launches()
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert gram_cuda.LAUNCHES == {"fwd": 0, "bwd_rows": 0, "bwd_cols": 0, "fwd_dchunk": 1}
    assert (K - want).abs().max() <= tol and K.min() < 0.5 * K.max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,m", [(500, 500), (257, 33), (500, 20)])
def test_2_byte_fwd_dchunk_is_the_fp32_kernel_rounded(dev, dtype, n, m):
    """At d = 90, at every candidate tiling: the 2-byte output with the noise
    diagonal equals the fp32 kernel's output plus the diagonal, rounded once,
    bit for bit (both store paths: m % 4 == 0 and not)."""
    xs, xps, sig = _wide_inputs(n + m, None, n, m, 90, dev, torch.float32, n == m)
    noise = torch.tensor(0.25, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for _, plan in gram_cuda.fwd_dchunk_candidates(n, m, 90, sms):
        K = _fwd_dchunk_call(plan, xs, xps, sig, diag_add=noise)
        got = _fwd_dchunk_call(plan, xs, xps, sig, out_dtype=dtype, diag_add=noise)
        assert got.dtype == dtype and torch.equal(got, K.to(dtype)), plan
    gram_cuda.reset_launches()
    got = gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=dtype, diag_add=noise)
    assert gram_cuda.LAUNCHES["fwd_dchunk"] == 1 and torch.equal(got, K.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m,d,square", [(3, 9700, 20, 130, False), (4, 300, 300, 90, True),
                                            (2, 257, 33, 65, False)])
def test_batched_fwd_dchunk_is_each_batchs_unbatched_call(dev, dtype, B, n, m, d, square):
    """One launch for the B Grams; batch b's K is bitwise an unbatched call
    on b's inputs (K's every entry is one sum in a fixed order at any
    tiling), and within the plain version's tolerance."""
    xs, xps, sig = _wide_inputs(B + n + d, B, n, m, d, dev, dtype, square)
    gram_cuda.reset_launches()
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert gram_cuda.LAUNCHES["fwd_dchunk"] == 1 and K.shape == (B, n, m)
    for b in range(B):
        assert torch.equal(K[b], gram_cuda.gram_fwd_cuda(xs[b], xps[b], sig[b])), b
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= tol


def test_float64_gram_refuses_a_2_byte_output(dev):
    xs = torch.zeros(4, 3, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        gram_cuda.gram_fwd_cuda(xs, xs, torch.tensor(1.0, dtype=torch.float64, device=dev),
                                out_dtype=torch.bfloat16)


@pytest.mark.parametrize("n,m,d", [(20, 20, 8), (500, 20, 8), (9701, 33, 8), (40000, 20, 8)])
def test_gram_bwd_cols_is_bitwise_deterministic_in_one_launch(dev, n, m, d):
    """The chunk partials are summed in a fixed order: two calls are equal
    bit for bit, and each call is one launch."""
    xs, xps, sig, g = _scaled(n * m + d, n, m, d, dev)
    gram_cuda.reset_launches()
    a = gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g)
    b = gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g)
    assert torch.equal(a, b)
    assert gram_cuda.LAUNCHES["bwd_cols"] == 2


@pytest.mark.parametrize("n,m,d", [(20, 20, 8), (500, 20, 8), (500, 500, 8), (9701, 33, 8),
                                   (40000, 20, 8), (20, 8192, 12), (8, 3000, 8)])
def test_gram_bwd_rows_is_bitwise_deterministic_in_one_launch(dev, n, m, d):
    """A row's lanes, the column slices (8 slices of 16 lanes at 500 x 500)
    and the column chunks (5 at 20 x 8192, summed by the last block of a row
    tile) are summed in a fixed order: two calls are equal bit for bit, and
    each is one launch."""
    xs, xps, sig, g = _scaled(n * m + d + 1, n, m, d, dev)
    gram_cuda.reset_launches()
    a = gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
    b = gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert gram_cuda.LAUNCHES["bwd_rows"] == 2
    plain = gram_cuda.gram_bwd_rows_plain(xs, xps, sig, g)
    for u, v in zip(a, plain):
        assert (u - v).abs().max() <= 1e-5 + 1e-4 * v.abs().max()


@pytest.mark.parametrize("n,m,d,rows_per_thread,vector_stores", [
    (500, 20, 8, 1, True), (500, 21, 8, 1, False), (2048, 512, 8, 2, True),
    (2048, 510, 8, 2, False), (1500, 1000, 8, 4, True), (3000, 1000, 8, 8, True),
    (4099, 1031, 8, 8, False), (3000, 1000, 64, 8, True), (700, 130, 5, 1, False),
    (120, 120, 1, 1, True)])
def test_gram_fwd_matches_plain_on_both_store_paths(dev, n, m, d, rows_per_thread,
                                                    vector_stores):
    """16-byte stores where m % 4 == 0 (the kernel's test, with an aligned
    output), masked scalar ones otherwise, at every rows-per-thread
    instantiation (and, at d = 64 with 8 rows a thread, more than 48 KB of
    shared memory); atol 2e-5 as in test_gram_kernels_match_plain. One launch
    a call."""
    plan = gram_cuda.fwd_plan(n, m, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.rows_per_thread == rows_per_thread and (m % 4 == 0) == vector_stores
    xs, xps, sig, _ = _scaled(n + 3 * m + d, n, m, d, dev)
    gram_cuda.reset_launches()
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    assert gram_cuda.LAUNCHES["fwd"] == 1
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= 2e-5


@pytest.mark.parametrize("n,d", [(5, 1), (500, 8), (2048, 8), (3000, 3)])
def test_gram_fwd_square_is_exactly_symmetric_with_exact_diagonal_at_every_tiling(dev, n, d):
    """K(u, u) from the redesigned forward, at plans with 1, 2 and 8 rows a
    thread and scalar and vector stores."""
    xs, _, sig, _ = _scaled(n + d, n, n, d, dev)
    K = gram_cuda.gram_fwd_cuda(xs, xs, sig)
    assert torch.equal(K, K.T)
    assert torch.equal(torch.diagonal(K), sig.expand(n))


def test_gram_kernels_of_empty_grams_launch_nothing(dev):
    xs, xps, sig, g = _scaled(3, 0, 20, 8, dev)
    gram_cuda.reset_launches()
    assert gram_cuda.gram_fwd_cuda(xs, xps, sig).shape == (0, 20)
    assert gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)[1].shape == (0,)
    # No rows: the column kernel still writes zeros.
    assert not gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g).any()
    assert gram_cuda.LAUNCHES == {"fwd": 0, "bwd_rows": 0, "bwd_cols": 1, "fwd_dchunk": 0}
    # No columns: the row kernel still writes zeros.
    xs, xps, sig, g = _scaled(4, 20, 0, 8, dev)
    d_xs, row = gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
    assert not d_xs.any() and not row.any()


def test_gram_kernel_square_is_exactly_symmetric_with_exact_diagonal(dev):
    xs, _, sig, _ = _scaled(1, 20, 20, 8, dev)
    K = gram_cuda.gram_fwd_cuda(xs, xs, sig)
    assert torch.equal(K, K.T)
    assert torch.equal(torch.diagonal(K), sig.expand(20))


def test_ard_gram_grads_on_cuda_match_cpu(dev):
    rng = np.random.default_rng(2)
    host = [rng.standard_normal((40, 3)), rng.standard_normal((7, 3)), np.float64(0.3),
            0.2 * rng.standard_normal(3)]
    g = torch.tensor(rng.standard_normal((40, 7)), dtype=torch.float32)
    grads = {}
    for where in ("cpu", dev):
        args = [torch.tensor(a, dtype=torch.float32, device=where, requires_grad=True)
                for a in host]
        K = gram(*args)
        grads[str(where)] = torch.autograd.grad(torch.sum(K * g.to(where)), args)
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_gram_on_cuda_launches_and_counts(dev):
    gram_cuda.reset_launches()
    u = torch.rand(20, 8, device=dev, requires_grad=True)
    gram(u, u, torch.tensor(0.0, device=dev), torch.zeros(8, device=dev)).sum().backward()
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 1, "bwd_cols": 1, "fwd_dchunk": 0}


def test_gram_on_cuda_raises_when_the_library_cannot_be_built(dev, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", broken)
    u = torch.rand(5, 2, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gram(u, u, 0.0, torch.zeros(2, device=dev))


def test_kernel_rejects_non_contiguous_cuda_input(dev):
    xs = torch.rand(8, 5, device=dev).T
    with pytest.raises(ValueError):
        gram_cuda.gram_fwd_cuda(xs, torch.rand(3, 8, device=dev), torch.tensor(1.0, device=dev))


def test_fit_steps_on_cuda_match_cpu_at_the_same_parameters(dev):
    """Five crps GD steps on CUDA; the loss at every recorded point agrees
    with the CPU's at the same parameters (rtol 1e-4)."""
    data = load_kin40k()
    gpu, cpu = kin40k_replicate_split(data, 0, device=dev), kin40k_replicate_split(data, 0)
    sched = SCHEDULES[("kin40k_fitc", "crps")]
    loss = make_objective("crps", model="fitc")
    res = fit_gd(loss, kin40k_fitc20_init(dev), gpu.train_x, gpu.train_y, 5, sched.lr,
                 sched.lr_inducing, record_params=True)
    p_cpu = kin40k_fitc20_init()
    for i in range(5):
        at = {f: t[i].cpu() for f, t in res.param_history.leaves().items()}
        want = loss(p_cpu.replace(**at), cpu.train_x, cpu.train_y)
        assert abs(float(res.loss_history[i]) - float(want)) <= 1e-4 * abs(float(want))


def test_fitc_inducing_gradient_on_cuda_matches_cpu_at_the_full_pool(dev):
    """The crps loss's gradient on the 9700-row pool, where gram_bwd_cols
    splits K_fu into 152 row chunks: CUDA against the CPU at the same
    parameters, each leaf within 1e-3 of its largest entry (chip_smoke.py's
    per-step tolerance), the inducing points' above all."""
    data = load_kin40k()
    loss = make_objective("crps", model="fitc")
    grads = {}
    for where in ("cpu", dev):
        split = kin40k_replicate_split(data, 0, n_subsample=9700, device=where)
        p = kin40k_fitc20_init(where)
        leaves = {f: t.clone().requires_grad_() for f, t in p.leaves().items()}
        value = loss(p.replace(**leaves), split.train_x, split.train_y)
        grads[str(where)] = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
    assert set(grads["cpu"]) >= {"inducing"}
    for f, want in grads["cpu"].items():
        got = grads[str(dev)][f].cpu()
        assert (got - want).abs().max() <= 1e-3 * want.abs().max(), f


# ---- the exact GP at small n --------------------------------------------------


def _kin40k_exact(where, seed=0):
    split = kin40k_replicate_split(load_kin40k(), 0, device=where)
    p = init_rand_params(torch.Generator().manual_seed(seed), 8)
    return split, p.replace(**{f: t.to(where) for f, t in p.leaves().items()})


@pytest.mark.parametrize("core", ["loo", "kfold"])
def test_solve_cores_on_cuda_match_cpu_at_n_500(dev, core):
    """Values (1e-4 of the largest entry) and the gradient of a random linear
    functional of both outputs (1e-3 of the largest entry), on K_hat of the
    KIN40K replicate-0 rows, CUDA against the CPU."""
    split, p = _kin40k_exact("cpu")
    K = gram(split.train_x, split.train_x, p.log_signal_sq, p.log_length) + 0.1 * torch.eye(500)
    rng = np.random.default_rng(1)
    c1 = torch.tensor(rng.standard_normal(500).astype(np.float32))
    c2 = torch.tensor(rng.standard_normal((4, 125, 125) if core == "kfold" else 500)
                      .astype(np.float32))
    got = {}
    for where in ("cpu", dev):
        Kw = K.to(where).requires_grad_()
        yw = split.train_y.to(where).requires_grad_()
        a, b = (linalg.kfold_solve_blocks(Kw, yw, 4) if core == "kfold"
                else linalg.loo_solve_diag(Kw, yw))
        value = torch.sum(c1.to(where) * a) + torch.sum(c2.to(where) * b)
        got[str(where)] = [t.detach().cpu() for t in (a, b, *torch.autograd.grad(value, [Kw, yw]))]
    for i, (g, w) in enumerate(zip(got[str(dev)], got["cpu"])):
        tol = (1e-4 if i < 2 else 1e-3) * w.abs().max()
        assert (g - w).abs().max() <= tol, i


@pytest.mark.parametrize("rule", ["crps", "nlml", "logs", "dss", "es", "kc", "interval"])
def test_exact_gd_step_on_cuda_matches_cpu(dev, rule):
    """One exact GD step at the same parameters on the KIN40K rows (n = 500,
    d = 8): loss rel 1e-4, the step's gradient within 1e-3 of each leaf's
    largest entry; es at fixed normals on both sides."""
    # kc has no kin40k_full schedule; it takes its FITC one's rate.
    sched = SCHEDULES.get(("kin40k_full", rule)) or SCHEDULES[("kin40k_fitc", rule)]
    eps = tuple(torch.tensor(np.random.default_rng(s).standard_normal((4, 125, 300))
                             .astype(np.float32)) for s in (2, 3))
    loss = make_objective(rule, model="exact")
    out = {}
    for where in ("cpu", dev):
        split, p = _kin40k_exact(where)
        e = tuple(a.to(where) for a in eps)
        res = fit_gd(lambda q, x, y, g=None: loss(q, x, y, eps=e), p, split.train_x,
                     split.train_y, 1, sched.lr)
        step = {f: (p.leaves()[f] - t).cpu() / sched.lr for f, t in res.params.leaves().items()}
        out[str(where)] = float(res.loss_history[0]), step
    (lg, sg), (lc, sc) = out[str(dev)], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for f, want in sc.items():
        assert (sg[f] - want).abs().max() <= 1e-3 * want.abs().max(), f


def test_driver_device_cuda_without_cuda_raises(dev, monkeypatch):
    from gpscore_torch.experiments import kin40k_full

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kin40k_full.main(["--replicates", "1", "--device", "cuda"])


# ---- the exact GP at large n ----------------------------------------------------


def _large_n_problem(dev, n=4096, d=8):
    from gpscore_torch.experiments import large_n
    from gpscore_torch.utils.params import init_unit_params

    x, y, _, _ = large_n.make_data(n, d, 0)
    p = init_unit_params(d, isotropic=False, device=dev)
    return x.to(dev), y.to(dev), p


@pytest.mark.parametrize("rule", ["crps", "logs", "interval", "nlml"])
def test_fused_objectives_on_cuda_match_the_dense_path_at_n_4096(dev, monkeypatch, rule):
    """The fused objective (block 1024: four panels) against the dense path on
    the card, n = 4096, d = 8: loss rel 1e-4, gradient within 1e-3 of each
    leaf's largest entry. A fused step launches gram_fwd once and each
    backward kernel once a row block."""
    from gpscore_torch.experiments.bench_ceiling import value_and_grad
    from gpscore_torch.fit import objectives

    x, y, p = _large_n_problem(dev)
    loss = make_objective(rule, model="exact", block=1024)
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 4097)
    want_v, want_g = value_and_grad(loss, p, x, y)
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 4096)
    gram_cuda.reset_launches()
    got_v, got_g = value_and_grad(loss, p, x, y)
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 4, "bwd_cols": 4, "fwd_dchunk": 0}
    assert abs(float(got_v) - float(want_v)) <= 1e-4 * abs(float(want_v))
    for f, want in want_g.items():
        assert (got_g[f] - want).abs().max() <= 1e-3 * want.abs().max(), f


@pytest.mark.parametrize("rule", ["dss", "kc", "es"])
def test_fold_objectives_on_cuda_match_the_dense_path_at_n_4096(dev, monkeypatch, rule):
    """The fold-streamed objective (block 1024, 4 folds; es at fixed normals)
    against the dense path on the card, n = 4096, d = 8: loss rel 1e-4,
    gradient within 1e-3 of each leaf's largest entry. A step launches
    gram_fwd once and each backward kernel once a fold and row block."""
    from gpscore_torch.experiments.bench_ceiling import value_and_grad
    from gpscore_torch.fit import objectives

    x, y, p = _large_n_problem(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    kw = {"eps": tuple(torch.randn((4, 1024, 300), generator=gen, device=dev)
                       for _ in range(2))} if rule == "es" else {}
    loss = make_objective(rule, model="exact", fold_k=4, block=1024)
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 4097)
    want_v, want_g = value_and_grad(loss, p, x, y, **kw)
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 4096)
    gram_cuda.reset_launches()
    got_v, got_g = value_and_grad(loss, p, x, y, **kw)
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 16, "bwd_cols": 16, "fwd_dchunk": 0}
    assert abs(float(got_v) - float(want_v)) <= 1e-4 * abs(float(want_v))
    for f, want in want_g.items():
        assert (got_g[f] - want).abs().max() <= 1e-3 * want.abs().max(), f


def test_fused_kfold_core_on_cuda_matches_the_dense_core(dev):
    """ArdKfoldSolveBlocks against KfoldSolveBlocks on the dense K_hat, n = 4096:
    the outputs (1e-4 of the largest entry) and the gradient of a random
    linear functional of both (1e-3 of each leaf's largest entry)."""
    from gpscore_torch.ops import loo_fused

    x, y, p = _large_n_problem(dev)
    rng = np.random.default_rng(5)
    c1 = torch.tensor(rng.standard_normal(4096).astype(np.float32), device=dev)
    c2 = torch.tensor(rng.standard_normal((4, 1024, 1024)).astype(np.float32), device=dev)
    out = {}
    for fused in (False, True):
        leaves = [t.clone().requires_grad_() for t in (p.log_signal_sq, p.log_length,
                                                       p.log_noise_sq)]
        if fused:
            a, A = loo_fused.ard_kfold_solve_blocks(*leaves, x, y, 4, 1024)
        else:
            K = gram(x, x, leaves[0], leaves[1]) + torch.exp(leaves[2]) * torch.eye(4096,
                                                                                   device=dev)
            a, A = linalg.kfold_solve_blocks(K, y, 4)
        value = torch.sum(c1 * a) + torch.sum(c2 * A)
        out[fused] = [a.detach(), A.detach(), *torch.autograd.grad(value, leaves)]
    for i, (g, w) in enumerate(zip(out[True], out[False])):
        assert (g - w).abs().max() <= (1e-4 if i < 2 else 1e-3) * w.abs().max(), i


def test_predictive_diag_large_on_cuda_matches_the_dense_predictive(dev):
    """exact_predictive_diag_large (block 1024, chunk 512 over 1000 test
    points) against exact_predictive's diagonal, n = 4096: within 1e-4 of the
    largest mean and variance (both solve with a Cholesky factor: 3e-7 and
    1e-6 of the variance against an fp64 solve on the CPU)."""
    from gpscore_torch.experiments import large_n
    from gpscore_torch.models import exact

    x, y, p = _large_n_problem(dev)
    _, _, xt, _ = large_n.make_data(4096, 8, 1000)
    xt = xt.to(dev)
    got = exact.exact_predictive_diag_large(x, y, xt, p, block=1024, chunk=512)
    sig, ll = p.log_signal_sq, p.log_length
    want = exact.exact_predictive(gram(xt, x, sig, ll), gram(x, x, sig, ll), gram(xt, xt, sig, ll),
                                  y, p.noise_sq)
    assert (got.mean - want.mean).abs().max() <= 1e-4 * want.mean.abs().max()
    var = torch.diagonal(want.cov)
    assert (got.cov - var).abs().max() <= 1e-4 * var.abs().max()


# ---- the fit replayed from a CUDA graph ------------------------------------------


def _graph_case(dev, model, rule):
    split = kin40k_replicate_split(load_kin40k(), 0, device=dev)
    if model == "fitc":
        sched, p0 = SCHEDULES[("kin40k_fitc", rule)], kin40k_fitc20_init(dev)
    else:
        sched = SCHEDULES[("kin40k_full", rule)]
        p0 = _kin40k_exact(dev)[1]

    def fit(iters, graph, **kw):
        gen = torch.Generator(device=dev).manual_seed(7) if rule == "es" else None
        return fit_gd(make_objective(rule, model=model), p0, split.train_x, split.train_y, iters,
                      sched.lr, sched.lr_inducing, generator=gen, graph=graph, **kw)

    return fit


@pytest.mark.parametrize("model,rule", [("fitc", "crps"), ("fitc", "dss"), ("exact", "es")])
def test_replayed_fit_equals_the_eager_fit_bit_for_bit(dev, model, rule):
    """50 steps with graph=True against graph=False from the same start: loss
    history, parameter histories, final parameters and stall_iters equal bit
    for bit; es draws from a seeded CUDA generator, which the graph advances
    as the eager loop does. The launch counters count the replays."""
    fit = _graph_case(dev, model, rule)
    fit(3, False)  # warm
    gram_cuda.reset_launches()
    eager = fit(50, False, record_params=True)
    eager_launches = dict(gram_cuda.LAUNCHES)
    gram_cuda.reset_launches()
    replayed = fit(50, True, record_params=True)
    assert gram_cuda.LAUNCHES == eager_launches
    assert eager_launches["bwd_rows"] == (100 if model == "fitc" else 50)
    assert torch.isfinite(eager.loss_history).all()
    assert torch.equal(replayed.loss_history, eager.loss_history)
    for f, want in eager.param_history.leaves().items():
        assert torch.equal(replayed.param_history.leaves()[f], want), f
        assert torch.equal(replayed.params.leaves()[f], eager.params.leaves()[f]), f
    assert int(replayed.stall_iters) == int(eager.stall_iters) == 0


def test_the_default_replays_from_the_capture_minimum_on(dev):
    """graph=None on a card: eager under GRAPH_MIN_ITERS iterations, replayed
    from there on (seen by the Python calls of the loss: every eager step
    makes one, a replayed fit the warm-up's and the capture's)."""
    from gpscore_torch.fit import train

    calls = []
    inner = make_objective("nlml", model="fitc")

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    split = kin40k_replicate_split(load_kin40k(), 0, device=dev)
    for iters, want in ((train.GRAPH_MIN_ITERS - 1, train.GRAPH_MIN_ITERS - 1),
                        (train.GRAPH_MIN_ITERS, train.GRAPH_WARMUP + 1)):
        calls.clear()
        res = fit_gd(counted, kin40k_fitc20_init(dev), split.train_x, split.train_y, iters, 1e-3)
        assert len(calls) == want and torch.isfinite(res.loss_history).all()


@pytest.mark.parametrize("n,m,d", [(500, 20, 8), (20, 8192, 12), (9701, 33, 8)])
def test_two_replays_of_a_captured_backward_are_bitwise_equal(dev, n, m, d):
    """The tickets are 0 again after every launch, so a graph that captured
    both backward kernels (with several chunks a tile at 20 x 8192 and 9701 x
    33) gives the eager result at every replay."""
    xs, xps, sig, g = _scaled(n + m, n, m, d, dev)
    want = gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gram_cuda.gram_bwd_cuda(xs, xps, sig, g)  # sizes the stream's workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
    for _ in range(2):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_workspace_growth_during_a_capture_raises(dev):
    xs, xps, sig, g = _scaled(5, 20, 8192, 12, dev)
    side = torch.cuda.Stream()
    gram_cuda._WORKSPACES.pop((xs.device, side.cuda_stream, torch.float32), None)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="would grow during a CUDA graph capture"):
        with torch.cuda.graph(graph, stream=side):
            gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
    # Outside a capture the same call sizes the workspace and runs.
    with torch.cuda.stream(side):
        d_xs, _ = gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g)
    side.synchronize()
    assert torch.isfinite(d_xs).all()


def test_a_loss_that_cannot_be_captured_raises_and_nothing_runs_on_eagerly(dev):
    """A loss that reads a device value on the host cannot be captured: the
    replayed fit raises PyTorch's capture error after the warm-up's and the
    capture's calls of the loss, and takes no eager step beyond them. In a
    process of its own: a failed capture may leave CUDA unusable."""
    import os
    import subprocess
    import sys

    code = """
import torch
from gpscore_torch.data import kin40k_fitc20_init, kin40k_replicate_split, load_kin40k
from gpscore_torch.fit import fit_gd, make_objective
from gpscore_torch.fit.train import GRAPH_WARMUP
dev = torch.device("cuda", 0)
s = kin40k_replicate_split(load_kin40k(), 0, device=dev)
inner, calls = make_objective("nlml", model="fitc"), []
def loss(p, x, y, generator=None):
    calls.append(1)
    value = inner(p, x, y)
    return value if float(value) > 0 else -value  # branches on a device value
try:
    fit_gd(loss, kin40k_fitc20_init(dev), s.train_x, s.train_y, 40, 1e-3)
except Exception as e:
    assert len(calls) == GRAPH_WARMUP + 1, calls
    print("RAISED", type(e).__name__)
else:
    print("RAN", len(calls))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


# ---- the precision modes ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,m,d,diag", [(500, 500, 8, True), (257, 33, 1, True),
                                        (1031, 70, 12, False), (4099, 1031, 8, True)])
def test_2_byte_gram_is_the_fp32_kernel_rounded(dev, dtype, n, m, d, diag):
    """Every tiling and both store paths (m % 4 == 0: one 8-byte store; else
    scalar): the 2-byte output equals the fp32 kernel's output (plus the noise
    diagonal) rounded once, bit for bit, and counts one launch."""
    xs, xps, sig, _ = _scaled(n + m + 3 * d, n, m, d, dev)
    if n == m:
        xps = xs
    noise = torch.tensor(0.25, device=dev) if diag else None
    K = gram_cuda.gram_fwd_cuda(xs, xps, sig)
    if diag:
        K.diagonal().add_(noise)
    # An fp32 K takes the diagonal after the launch: the same values.
    assert torch.equal(gram_cuda.gram_fwd_cuda(xs, xps, sig, diag_add=noise), K)
    gram_cuda.reset_launches()
    got = gram_cuda.gram_fwd_cuda(xs, xps, sig, out_dtype=dtype, diag_add=noise)
    assert gram_cuda.LAUNCHES["fwd"] == 1
    assert got.dtype == dtype and torch.equal(got, K.to(dtype))


def test_mm_dtype_and_the_modes_products_on_the_card(dev):
    """aten::mm.dtype exists (the 2-byte modes take it); the reduced fp32
    modes against float64 relative to max(|A| |B|) at an inner dimension of
    4096, where "high" splits: 3 x TF32 in chunks within 1e-6, one pass
    within its 2.5e-3 grade; TF32 is off after."""
    from gpscore_torch.utils import precision

    assert hasattr(torch.ops.aten.mm, "dtype")
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((1024, 4096), generator=gen, device=dev)
    B = torch.randn((4096, 1536), generator=gen, device=dev)
    want = A.double() @ B.double()
    scale = float((A.double().abs() @ B.double().abs()).max())
    for mode, tol in (("highest", 1e-6), ("high", 1e-6), ("fast", 2.5e-3)):
        with precision.matmul_mode(mode):
            err = float((precision.matmul(A, B).double() - want).abs().max()) / scale
        assert err <= tol, (mode, err)
    assert not torch.backends.cuda.matmul.allow_tf32
    for st in (torch.bfloat16, torch.float16):
        got = precision.matmul_acc32(A.to(st), B.to(st))
        ref = A.to(st).double() @ B.to(st).double()
        assert got.dtype == torch.float32
        assert float((got.double() - ref).abs().max()) <= 1e-5 * scale


# ---- the batch axis (restarts and replicates) ------------------------------------


def _batched(seed, B, n, m, d, dev, square=False):
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.uniform(-1, 1, (B, n, d)).astype(np.float32), device=dev)
    xps = xs if square else torch.tensor(rng.uniform(-1, 1, (B, m, d)).astype(np.float32),
                                         device=dev)
    sig = torch.tensor(rng.uniform(0.5, 2.0, B).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((B, n, m)).astype(np.float32), device=dev)
    return xs, xps, sig, g


def _all_three(xs, xps, sig, g):
    return (gram_cuda.gram_fwd_cuda(xs, xps, sig), *gram_cuda.gram_bwd_rows_cuda(xs, xps, sig, g),
            gram_cuda.gram_bwd_cols_cuda(xs, xps, sig, g))


@pytest.mark.parametrize("B,n,m,d,square", [
    (16, 500, 20, 8, False), (16, 20, 20, 8, True), (10, 500, 500, 8, True),
    (3, 20, 8192, 12, False), (5, 9701, 33, 8, False), (4, 257, 33, 1, False),
    (1, 500, 20, 8, False)])
def test_batched_kernels_are_each_batchs_unbatched_launch(dev, B, n, m, d, square):
    """One launch per kernel for all B Grams; batch b's K is bitwise that of
    an unbatched launch on b's inputs, and so is each backward output
    wherever the plan tiles a batch as it tiles one Gram alone (at B = 1
    always; at 16 x 500 x 20 the row kernel takes 4 columns a trip against
    32 alone, so its sums run in another order); at 3 x 20 x 8192 the row
    kernel's column chunks and at 5 x 9701 x 33 the column kernel's row
    chunks (tickets and scratch per batch); a second call is bitwise equal;
    the batched plain versions agree within the unbatched tolerances."""
    xs, xps, sig, g = _batched(B + n + m + d, B, n, m, d, dev, square)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tiled_alike(plan):
        batched, alone = plan(n, m, d, sms, B), plan(n, m, d, sms)
        extra = {"blocks": alone.blocks} if hasattr(alone, "blocks") else {}
        return batched._replace(batch=1, **extra) == alone

    rows = tiled_alike(gram_cuda.bwd_rows_plan)
    # K's every entry is one sum in a fixed order at any tiling.
    same = [True, rows, rows, tiled_alike(gram_cuda.bwd_cols_plan)]
    gram_cuda.reset_launches()
    got = _all_three(xs, xps, sig, g)
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 1, "bwd_cols": 1, "fwd_dchunk": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, _all_three(xs, xps, sig, g)))
    if B == 1:
        assert all(same)
    for b in range(B):
        one = _all_three(xs[b], xps[b], sig[b], g[b])
        for u, v, s in zip(got, one, same):
            if s:
                assert torch.equal(u[b], v), b
            else:
                assert (u[b] - v).abs().max() <= 1e-5 + 1e-4 * v.abs().max(), b
    K = got[0]
    assert (K - gram_cuda.gram_fwd_plain(xs, xps, sig)).abs().max() <= 2e-5 * float(sig.max())
    plain = (*gram_cuda.gram_bwd_rows_plain(xs, xps, sig, g),
             gram_cuda.gram_bwd_cols_plain(xs, xps, sig, g))
    for a, want in zip(got[1:], plain):
        assert (a - want).abs().max() <= 1e-5 + 1e-4 * want.abs().max()


def test_batched_kernels_take_a_shared_input(dev):
    """xs shared by every batch (stride 0) and one sig for all: each batch as
    its unbatched launch."""
    xs, xps, _, g = _batched(7, 4, 300, 20, 8, dev)
    shared, sig = xs[0].contiguous(), torch.tensor(1.3, device=dev)
    got = _all_three(shared, xps, sig, g)
    assert got[0].shape == (4, 300, 20) and got[1].shape == (4, 300, 8)
    for b in range(4):
        one = _all_three(shared, xps[b], sig, g[b])
        assert all(torch.equal(u[b], v) for u, v in zip(got, one)), b


def test_two_replays_of_a_captured_batched_backward_are_bitwise_equal(dev):
    """Tickets per (batch, tile) go back to 0 in every batch: a captured
    batched backward with chunks in both kernels replays the eager result."""
    for B, n, m, d in ((3, 20, 8192, 12), (4, 9701, 33, 8)):
        xs, xps, sig, g = _batched(B * n, B, n, m, d, dev)
        want = gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = gram_cuda.gram_bwd_cuda(xs, xps, sig, g)
        for _ in range(2):
            for t in out:
                t.fill_(float("nan"))
            graph.replay()
            assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("model,rule", [("fitc", "crps"), ("fitc", "nlml"), ("exact", "dss")])
def test_batched_replayed_sweep_equals_the_batched_eager_sweep(dev, model, rule):
    """restart_sweep of 4 restarts, 40 steps, replayed against eager from the
    same starts: loss histories and final parameters equal bit for bit, one
    launch of each kernel a step for all restarts (FITC: two Grams a step)."""
    from gpscore_torch.parallel import restart_sweep

    split = kin40k_replicate_split(load_kin40k(), 0, device=dev)
    R = 4
    pb = init_rand_params(torch.Generator().manual_seed(3), 8,
                          num_inducing=20 if model == "fitc" else 0, batch=R)
    pb = pb.replace(**{f: t.to(dev) for f, t in pb.leaves().items()})
    loss = make_objective(rule, model=model)
    runs = {}
    for graph in (False, True):
        gram_cuda.reset_launches()
        runs[graph] = restart_sweep(loss, pb, split.train_x, split.train_y, 40, 1e-3,
                                    graph=graph)
        assert gram_cuda.LAUNCHES["fwd"] == 40 * (2 if model == "fitc" else 1)
    assert runs[True].loss_history.shape == (R, 40)
    assert torch.isfinite(runs[False].loss_history).all()
    assert torch.equal(runs[True].loss_history, runs[False].loss_history)
    for f, t in runs[False].params.leaves().items():
        assert torch.equal(runs[True].params.leaves()[f], t), f


# ---- batches past the grid's z limit, and the analysis suite -----------------------


@pytest.mark.parametrize("B,shared", [(65535, False), (65535 + 4, False), (2 * 65535 + 7, True)])
def test_a_batch_past_the_grid_limit_launches_in_chunks(dev, B, shared):
    """Each kernel launches once per chunk of batch_chunks(B) (one up to
    65,535); each chunk's Grams are bitwise that chunk called alone, and all
    agree with the batched plain versions. ``shared``: xs shared by every
    batch (stride 0) beside batched xps, sig and g."""
    n, m, d = 6, 5, 2
    rng = np.random.default_rng(B)
    xs = torch.tensor(rng.uniform(-1, 1, (n, d) if shared else (B, n, d)).astype(np.float32),
                      device=dev)
    xps = torch.tensor(rng.uniform(-1, 1, (B, m, d)).astype(np.float32), device=dev)
    sig = torch.tensor(rng.uniform(0.5, 2.0, B).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((B, n, m)).astype(np.float32), device=dev)
    chunks = _build.batch_chunks(B)
    calls = {"fwd": lambda *a: (gram_cuda.gram_fwd_cuda(*a[:3]),),
             "bwd_rows": gram_cuda.gram_bwd_rows_cuda,
             "bwd_cols": lambda *a: (gram_cuda.gram_bwd_cols_cuda(*a),)}
    plains = {"fwd": lambda *a: (gram_cuda.gram_fwd_plain(*a[:3]),),
              "bwd_rows": gram_cuda.gram_bwd_rows_plain,
              "bwd_cols": lambda *a: (gram_cuda.gram_bwd_cols_plain(*a),)}
    for key, call in calls.items():
        gram_cuda.reset_launches()
        got = call(xs, xps, sig, g)
        assert gram_cuda.LAUNCHES[key] == len(chunks) == -(-B // 65535)
        for start, size in chunks:
            part = slice(start, start + size)
            alone = call(xs if shared else xs[part], xps[part], sig[part], g[part])
            assert all(torch.equal(a[part], b) for a, b in zip(got, alone)), (key, start)
        for a, b in zip(got, plains[key](xs, xps, sig, g)):
            assert (a - b).abs().max() <= 2e-5 + 1e-4 * b.abs().max(), key


def test_objective_surface_on_cuda_matches_the_cpu(dev):
    from gpscore_torch.analysis import objective_surface

    rng = np.random.default_rng(0)
    x = torch.tensor((2.0 * rng.standard_normal((20, 1))).astype(np.float32))
    y = torch.tensor(rng.standard_normal(20).astype(np.float32))
    ls, ns = torch.linspace(0.2, 4.0, 12), torch.linspace(0.05, 1.5, 10)
    for rule in ("nlml", "crps", "logs", "wrong_crps"):
        gram_cuda.reset_launches()
        got = objective_surface(x.to(dev), y.to(dev), ls.to(dev), ns.to(dev), rule=rule).cpu()
        assert gram_cuda.LAUNCHES["fwd"] == 1
        want = objective_surface(x, y, ls, ns, rule=rule)
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


def test_parity_report_passes_on_cuda_in_float32_and_refuses_float64(dev):
    """The name is historical: float64 now runs through the Gram kernel's
    float64 build on the card and passes every 5e-9 target."""
    from gpscore_torch.experiments import parity_report

    assert parity_report.main([]) == 0
    assert parity_report.main(["--dtype", "float64"]) == 0


# ---- the small factor-and-solve (csrc/chol_small.cu) -----------------------------


def _chol_small_inputs(m, k, lead, dev, dtype, seed):
    """A well-conditioned SPD A (eigenvalues in [1, ~5]) and B, drawn in
    float64 on the CPU and cast: the fp32 and fp64 kernels see one problem."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((*lead, m, m), generator=g, dtype=torch.float64)
    A = v @ v.mT / m + torch.eye(m, dtype=torch.float64)
    B = torch.randn((*lead, m, k), generator=g, dtype=torch.float64)
    return A.to(dev, dtype), B.to(dev, dtype)


def _chol_small_vjp(A, B, full, cL, cX):
    """(L, X, A_bar, B_bar) of CholSolveSmall (the kernels on a card, the
    emulation on the CPU) under the cotangents cL and cX."""
    A, B = A.detach().requires_grad_(), B.detach().requires_grad_()
    L, X = linalg.CholSolveSmall.apply(A, B, full)
    gA, gB = torch.autograd.grad((L * cL).sum() + (X * cX).sum(), (A, B))
    return L.detach(), X.detach(), gA, gB


CHOL_SMALL_SHAPES = ([(m, k, lead) for m in (1, 2, 20, linalg.CHOL_SMALL_MAX_M)
                      for k in (1, 125, 500) for lead in ((), (4,), (3, 4))]
                     + [(20, 500, (64,)), (20, 1, (64, 4)), (20, 9700, ()),
                        (linalg.CHOL_SMALL_MAX_M, 500, (64,))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("m,k,lead", CHOL_SMALL_SHAPES)
def test_chol_small_kernels_match_the_emulation_and_float64(dev, dtype, full, m, k, lead):
    """L, X and both gradients of the kernel pair against the CPU emulation
    in float64 and against the emulation's formulas on the card in the
    kernels' dtype: fp32 to 2e-5 (values) and 1e-4 (gradients: S sums k
    products) of the largest reference entry, fp64 to 1e-11. A second call is
    bitwise the first and A_bar is exactly symmetric."""
    A, B = _chol_small_inputs(m, k, lead, dev, dtype, seed=100 * m + k)
    g = torch.Generator().manual_seed(m + k)
    cL = torch.randn(A.shape, generator=g, dtype=torch.float64)
    cX = torch.randn(B.shape, generator=g, dtype=torch.float64)
    got = _chol_small_vjp(A, B, full, cL.to(dev, dtype), cX.to(dev, dtype))
    again = _chol_small_vjp(A, B, full, cL.to(dev, dtype), cX.to(dev, dtype))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[2], got[2].mT)
    f64 = _chol_small_vjp(A.cpu().double(), B.cpu().double(), full, cL, cX)
    L = linalg.chol_factor(A)
    X = linalg.chol_solve_from_factor(L, B) if full else linalg.tri_solve(L, B)
    A_bar, Bbar_t = linalg._chol_small_bwd_plain(L, X.mT, cL.to(dev, dtype),
                                                 cX.to(dev, dtype).mT, full)
    plain = (L, X, A_bar, Bbar_t.mT)
    v_tol, g_tol = (2e-5, 1e-4) if dtype == torch.float32 else (1e-11, 1e-11)
    for i, (a, want64, want) in enumerate(zip(got, f64, plain)):
        tol = (v_tol if i < 2 else g_tol) * float(want64.abs().max())
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert (a.double().cpu() - want64).abs().max() <= tol, (i, "float64")
        assert (a - want).abs().max() <= 2 * tol, (i, "emulation")


@pytest.mark.parametrize("full", [False, True])
def test_chol_solve_small_past_the_kernels_m_is_the_library_chain(dev, full):
    """m = 33 (past CHOL_SMALL_MAX_M, the kernels' 32): the dispatcher takes
    the library chain, bit for bit, and counts it; the kernels refuse it."""
    A, B = _chol_small_inputs(33, 125, (3, 4), dev, torch.float32, seed=33)
    before = dict(linalg.CHOL_SMALL)
    L, X = linalg.chol_solve_small(A, B, full=full)
    assert linalg.CHOL_SMALL == {"fused": before["fused"], "library": before["library"] + 1}
    Lw = linalg.chol_factor(A)
    Xw = linalg.chol_solve_from_factor(Lw, B) if full else linalg.tri_solve(Lw, B)
    assert torch.equal(L, Lw) and torch.equal(X, Xw)
    with pytest.raises(ValueError, match="m <= 32"):
        linalg.CholSolveSmall.apply(A, B, full)
    # B of other leading dimensions than A's: the chain, which broadcasts; the
    # kernels refuse it.
    A, B = _chol_small_inputs(20, 125, (4,), dev, torch.float32, seed=20)
    assert linalg.chol_small_path(A[0], B) == "library"
    with pytest.raises(ValueError, match="same leading dimensions"):
        linalg.CholSolveSmall.apply(A[0], B, full)


@pytest.mark.parametrize("full", [False, True])
def test_chol_small_kernels_fail_one_matrix_as_chol_factor(dev, full):
    """A non-SPD matrix in a batch: its factor NaN on and below the diagonal
    and 0 above, its X and gradients NaN; its neighbours finite and equal to
    their own unbatched launches."""
    A, B = _chol_small_inputs(20, 500, (4,), dev, torch.float32, seed=3)
    A[2, 5, 5] = -3.0
    A.requires_grad_()
    B.requires_grad_()
    L, X = linalg.CholSolveSmall.apply(A, B, full)
    tri = torch.ones(20, 20, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[2][tri]).all() and (L[2][~tri] == 0).all() and torch.isnan(X[2]).all()
    gA, gB = torch.autograd.grad(linalg.half_logdet(L).sum() + X.sum(), (A, B))
    assert torch.isnan(gA[2]).all() and torch.isnan(gB[2]).all()
    for i in (0, 1, 3):
        L1, X1 = linalg.CholSolveSmall.apply(A[i].detach(), B[i].detach(), full)
        assert torch.equal(L[i], L1) and torch.equal(X[i], X1)
        assert torch.isfinite(gA[i]).all() and torch.isfinite(gB[i]).all()


@pytest.mark.parametrize("rule", ["crps", "nlml", "logs", "dss", "kc"])
def test_a_fitc_step_replayed_equals_its_eager_step_through_chol_small(dev, rule):
    """Each FITC-20 rule's fit, replayed against eager, bit for bit (the
    replays run the captured kernel pairs); an eager step makes 2 fused
    calls (crps, nlml, logs: L_uu and L_M) or 3 (dss, kc: and the folds'
    L_Mf), and none takes the library chain."""
    fit = _graph_case(dev, "fitc", rule)
    fit(3, False)  # warm
    before = dict(linalg.CHOL_SMALL)
    eager = fit(20, False)
    assert linalg.CHOL_SMALL["library"] == before["library"]
    per_step = (linalg.CHOL_SMALL["fused"] - before["fused"]) / 20
    assert per_step == (3 if rule in ("dss", "kc") else 2)
    replayed = fit(20, True)
    assert torch.isfinite(eager.loss_history).all()
    assert torch.equal(replayed.loss_history, eager.loss_history)
    for f, want in eager.params.leaves().items():
        assert torch.equal(replayed.params.leaves()[f], want), f
