"""The port's FITC model and small-matrix linear algebra against gpscore's.

Same numpy inputs through both packages on the CPU; moments to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.models import fitc as jfitc
from gpscore.ops import linalg as jlinalg
from gpscore_torch.models import fitc as tfitc
from gpscore_torch.ops import linalg as tlinalg
from torch_parity import close, jax_fold_eps, jax_params, problem, t, torch_params

RTOL = 1e-5
FOLDS = 4


@pytest.fixture(scope="module")
def prob():
    x, y, p = problem(seed=0, n=64, m=6, d=3)
    return x, y, p, jnp.asarray(x), jnp.asarray(y), jax_params(p), t(x), t(y), torch_params(p)


def _scale_atol(want, rtol=RTOL):
    return rtol * float(np.max(np.abs(np.asarray(want))))


def test_fitc_terms_match_jax(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    want = jfitc.fitc_terms(jx, jp)
    got = tfitc.fitc_terms(tx, tp)
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), RTOL, _scale_atol(getattr(want, f)))


def test_woodbury_pieces_match_jax(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    r = np.random.default_rng(1).standard_normal((x.shape[0], 2)).astype(np.float32)
    jt, tt = jfitc.fitc_terms(jx, jp), tfitc.fitc_terms(tx, tp)
    want = jfitc._b_inv_apply(jt, jnp.asarray(r))
    close(tfitc._b_inv_apply(tt, t(r)), want, RTOL, _scale_atol(want))
    close(tfitc._b_inv_diag(tt), jfitc._b_inv_diag(jt), RTOL)
    close(tfitc.fitc_half_logdet(tt), jfitc.fitc_half_logdet(jt), RTOL)


@pytest.mark.parametrize("kind", ["ard", "rbf"])
def test_nlml_fitc_value_and_grad_match_jax(prob, kind):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    if kind == "rbf":
        p = dict(p, log_length=np.float32(-0.3))
        jp = jax_params(p)
    want, jg = jax.value_and_grad(lambda q: jfitc.nlml_fitc(jx, jy, q, kind=kind))(jp)
    tq = torch_params(p, requires_grad=True)
    got = tfitc.nlml_fitc(tx, ty, tq, kind=kind)
    close(got, want, RTOL)
    grads = torch.autograd.grad(got, list(tq.leaves().values()))
    for f, g in zip(tq.leaves(), grads):
        w = getattr(jg, f)
        close(g, w, 1e-4, _scale_atol(w, 1e-4))


@pytest.mark.parametrize("variance_correction", [False, True])
def test_loo_fitc_matches_jax(prob, variance_correction):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    want = jfitc.loo_fitc(jx, jy, jp, variance_correction=variance_correction)
    got = tfitc.loo_fitc(tx, ty, tp, variance_correction=variance_correction)
    close(got.mean, want.mean, RTOL, _scale_atol(want.mean))
    close(got.cov, want.cov, RTOL)


def test_fitc_predictive_matches_jax(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    xs = np.random.default_rng(2).uniform(-1, 1, (20, 3)).astype(np.float32)
    want = jfitc.fitc_predictive(jx, jy, jnp.asarray(xs), jp)
    got = tfitc.fitc_predictive(tx, ty, t(xs), tp)
    close(got.mean, want.mean, RTOL, _scale_atol(want.mean))
    close(got.cov, want.cov, RTOL, _scale_atol(want.cov))
    # The variance clamp: every predictive variance is at least noise_sq.
    assert float(torch.diagonal(got.cov).min()) >= float(tp.noise_sq) * (1 - 1e-6)


def test_kfold_fitc_lowrank_matches_jax(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    want = jfitc.kfold_fitc_lowrank(jx, jy, jp, FOLDS)
    got = tfitc.kfold_fitc_lowrank(tx, ty, tp, FOLDS)
    for f in want._fields:
        w = getattr(want, f)
        close(getattr(got, f), w, RTOL, _scale_atol(w))
    fold_terms = tfitc._fitc_fold_terms(tx, ty, tp, FOLDS, "ard")
    for a, b in zip(fold_terms, jfitc._fitc_fold_terms(jx, jy, jp, FOLDS, "ard")):
        close(a, b, RTOL, _scale_atol(b))
    with pytest.raises(ValueError):
        tfitc.kfold_fitc_lowrank(tx[:63], ty[:63], tp, FOLDS)


def test_lowrank_fold_functions_match_jax(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    jpr = jfitc.kfold_fitc_lowrank(jx, jy, jp, FOLDS)
    tpr = tfitc.kfold_fitc_lowrank(tx, ty, tp, FOLDS)
    r = np.random.default_rng(3).standard_normal((FOLDS, x.shape[0] // FOLDS)).astype(np.float32)
    close(tfitc.lowrank_fold_logdet_cov(tpr), jfitc.lowrank_fold_logdet_cov(jpr), RTOL)
    close(tfitc.lowrank_fold_quad(tpr, t(r)), jfitc.lowrank_fold_quad(jpr, jnp.asarray(r)), RTOL)
    close(tfitc.lowrank_fold_cov_diag(tpr), jfitc.lowrank_fold_cov_diag(jpr), RTOL)


def test_lowrank_fold_sample_matches_jax_with_its_draws(prob):
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    jpr = jfitc.kfold_fitc_lowrank(jx, jy, jp, FOLDS)
    tpr = tfitc.kfold_fitc_lowrank(tx, ty, tp, FOLDS)
    key = jax.random.PRNGKey(7)
    want = jfitc.lowrank_fold_sample(key, jpr, 16)
    eps = jax_fold_eps(key, FOLDS, x.shape[0] // FOLDS, p["inducing"].shape[0], 16)
    got = tfitc.lowrank_fold_sample(tpr, 16, eps=eps)
    assert got.shape == (FOLDS, 16, x.shape[0] // FOLDS)
    close(got, want, 1e-4, _scale_atol(want, 1e-4))


def test_lowrank_fold_sample_from_a_generator_has_the_fold_covariance(prob):
    """Drawn from a torch.Generator: the sample covariance of each fold
    approaches A_b^-1 (diagonal checked against lowrank_fold_cov_diag)."""
    x, y, p, jx, jy, jp, tx, ty, tp = prob
    tpr = tfitc.kfold_fitc_lowrank(tx, ty, tp, FOLDS)
    gen = torch.Generator().manual_seed(0)
    z = tfitc.lowrank_fold_sample(tpr, 20000, generator=gen)
    var = z.var(dim=1)
    close(var, tfitc.lowrank_fold_cov_diag(tpr), 0.05)


# ---- linear algebra ---------------------------------------------------------


def _spd(seed, n, batch=()):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(batch + (n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def test_cholesky_solves_match_jax():
    A = _spd(0, 6)
    B = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
    jL, tL = jlinalg.chol_factor(jnp.asarray(A)), tlinalg.chol_factor(t(A))
    close(tL, jL, RTOL, 1e-6)
    for trans in (False, True):
        close(tlinalg.tri_solve(tL, t(B), trans=trans),
              jlinalg.tri_solve(jL, jnp.asarray(B), trans=trans), RTOL, 1e-6)
    close(tlinalg.chol_solve(t(B), t(A)), jlinalg.chol_solve(jnp.asarray(B), jnp.asarray(A)),
          RTOL, 1e-6)
    close(tlinalg.chol_solve_from_factor(tL, t(B)),
          jlinalg.chol_solve_from_factor(jL, jnp.asarray(B)), RTOL, 1e-6)
    close(tlinalg.half_logdet(tL), jlinalg.half_logdet(jL), RTOL)
    close(tlinalg.inv_diag_from_chol(tL), jlinalg.inv_diag_from_chol(jL), RTOL)


def test_batched_linalg_matches_vmapped_jax():
    A = _spd(2, 5, batch=(4,))
    B = np.random.default_rng(3).standard_normal((4, 5, 2)).astype(np.float32)
    jL = jax.vmap(jlinalg.chol_factor)(jnp.asarray(A))
    tL = tlinalg.chol_factor(t(A))
    close(tL, jL, RTOL, 1e-6)
    close(tlinalg.tri_solve(tL, t(B), trans=True),
          jax.vmap(lambda L, b: jlinalg.tri_solve(L, b, trans=True))(jL, jnp.asarray(B)),
          RTOL, 1e-6)
    close(tlinalg.half_logdet(tL), jax.vmap(jlinalg.half_logdet)(jL), RTOL)
    close(tlinalg.inv_diag_from_chol(tL), jax.vmap(jlinalg.inv_diag_from_chol)(jL), RTOL)


def test_failed_cholesky_is_nan_like_jax_and_does_not_raise():
    """jnp.linalg.cholesky returns NaN for a non-SPD input; torch's raises. The
    port must return NaN (fit_gd's masking and safe_cholesky depend on it)."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32)
    batch = np.stack([np.eye(2, dtype=np.float32), bad])
    want = np.asarray(jlinalg.chol_factor(jnp.asarray(batch)))
    got = tlinalg.chol_factor(t(batch)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[0], np.eye(2))
    np.testing.assert_array_equal(np.nan_to_num(got[1], nan=-1.0), np.nan_to_num(want[1], nan=-1.0))
    # The gradient through a failed factor is NaN in both packages.
    jg = jax.grad(lambda a: jnp.sum(jlinalg.half_logdet(jlinalg.chol_factor(a))))(
        jnp.asarray(bad))
    a = t(bad).requires_grad_()
    (tg,) = torch.autograd.grad(tlinalg.half_logdet(tlinalg.chol_factor(a)), [a])
    assert np.isnan(np.asarray(jg)).any() and torch.isnan(tg).any()


@pytest.mark.parametrize("shift,ok", [(0.0, True), (-1e-7, True), (-100.0, False)])
def test_safe_cholesky_matches_jax(shift, ok):
    """Healthy input: the first rung; nearly singular: a jitter rung recovers;
    hopeless: ok is False and L is NaN, in both packages."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    A = (v @ v.T + shift * np.eye(5, dtype=np.float32)).astype(np.float32)
    if shift == 0.0:
        A = _spd(5, 5)
    jL, jok = jlinalg.safe_cholesky(jnp.asarray(A))
    tL, tok = tlinalg.safe_cholesky(t(A))
    assert bool(tok) == bool(jok) == ok
    if ok:
        # The jittered rank-3 case has an ill-conditioned trailing block, so
        # compare the factored matrices (same rung taken), not the factors.
        close(tL @ tL.T, np.asarray(jL @ jL.T), 1e-5, 1e-5 * float(np.abs(A).max()))
    else:
        assert torch.isnan(tL).any() and np.isnan(np.asarray(jL)).any()
