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
    assert gram_cuda.LAUNCHES == {"fwd": 0, "bwd_rows": 0, "bwd_cols": 1}
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
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 1, "bwd_cols": 1}


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
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 4, "bwd_cols": 4}
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
    assert gram_cuda.LAUNCHES == {"fwd": 1, "bwd_rows": 16, "bwd_cols": 16}
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
