"""The port's exact GP at small n against gpscore's: the two closed-form solve
cores, the exact model, the block scoring rules and the seven exact
objectives, values and gradients; against the fp64 oracle of tests/oracle.py
where it has the formula.

Tolerances: values rtol 1e-4 against JAX (fp32 on both sides); gradients rtol
1e-4 with atol 1e-4 of the largest entry of the JAX gradient (the fp32 sums of
a backward, taken in another order); against the fp64 oracle, rtol 1e-4 with
the atol stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from gpscore.fit import make_objective as jax_make_objective
from gpscore.models import exact as jexact
from gpscore.ops import linalg as jlinalg
from gpscore.scoring import rules as jrules
from gpscore_torch.fit import OBJECTIVE_RULES, eval_predictive_metrics, make_objective
from gpscore_torch.models import exact as texact
from gpscore_torch.ops import linalg as tlinalg
from gpscore_torch.scoring import rules as trules
from torch_parity import close, jax_params, problem, t, torch_params

RTOL = 1e-4
FOLDS = 4
NUM_SIM = 32


def _grad_atol(w):
    return RTOL * float(np.max(np.abs(np.asarray(w))))


def _exact_problem(seed=0, n=48, d=3):
    x, y, p = problem(seed=seed, n=n, m=1, d=d)
    return x, y, dict(p, inducing=None)


def _k_ff(x, p):
    return oracle.ard_gram(x, x, p["log_signal_sq"], p["log_length"]).astype(np.float32)


def _spd(seed, n):
    """A well-conditioned SPD matrix, float32, and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    K = (a @ a.T / n + np.eye(n)).astype(np.float32)
    return K, rng.standard_normal(n).astype(np.float32)


def _cotangents(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---- the solve cores ---------------------------------------------------------


def test_spd_inverse_matches_jax_and_numpy():
    K, _ = _spd(1, 40)
    got = tlinalg.spd_inverse(t(K))
    close(got, jlinalg.spd_inverse(jnp.asarray(K)), RTOL, 1e-6)
    close(got, np.linalg.inv(K.astype(np.float64)), RTOL, 1e-6)
    close(tlinalg.spd_inverse(L=tlinalg.chol_factor(t(K))), got.numpy(), 0, 0)


@pytest.mark.parametrize("used", ["a", "d", "both"])
def test_loo_solve_diag_matches_the_jax_custom_vjp(used):
    """Values, and the gradient of a linear functional of the outputs used:
    an unused output arrives as a zero cotangent (nlml-like "a" only; the
    LOO objectives use both)."""
    K, y = _spd(2, 32)
    ca, cd = _cotangents(3, (32,), (32,))
    wa, wd = (1.0 if used in ("a", "both") else 0.0), (1.0 if used in ("d", "both") else 0.0)

    def jf(K, y):
        a, d = jlinalg.loo_solve_diag(K, y)
        return wa * jnp.sum(ca * a) + wd * jnp.sum(cd * d)

    jv, (jK, jy) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(y))
    tK, ty = t(K).requires_grad_(), t(y).requires_grad_()
    a, d = tlinalg.loo_solve_diag(tK, ty)
    close(a, jlinalg.loo_solve_diag(jnp.asarray(K), jnp.asarray(y))[0], RTOL, 1e-6)
    close(d, jlinalg.loo_solve_diag(jnp.asarray(K), jnp.asarray(y))[1], RTOL, 1e-6)
    terms = ([torch.sum(t(ca) * a)] if wa else []) + ([torch.sum(t(cd) * d)] if wd else [])
    tv = sum(terms)
    close(tv, jv, RTOL, 1e-6)
    gK, gy = torch.autograd.grad(tv, [tK, ty])
    close(gK, jK, RTOL, _grad_atol(jK))
    close(gy, jy, RTOL, _grad_atol(jy) + 1e-12)


@pytest.mark.parametrize("used", ["a", "A", "both"])
def test_kfold_solve_blocks_matches_the_jax_custom_vjp(used):
    K, y = _spd(4, 32)
    ca, cA = _cotangents(5, (32,), (FOLDS, 8, 8))
    wa, wA = (1.0 if used in ("a", "both") else 0.0), (1.0 if used in ("A", "both") else 0.0)

    def jf(K, y):
        a, A = jlinalg.kfold_solve_blocks(K, y, FOLDS)
        return wa * jnp.sum(ca * a) + wA * jnp.sum(cA * A)

    jv, (jK, jy) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(y))
    ja, jA = jlinalg.kfold_solve_blocks(jnp.asarray(K), jnp.asarray(y), FOLDS)
    tK, ty = t(K).requires_grad_(), t(y).requires_grad_()
    a, A = tlinalg.kfold_solve_blocks(tK, ty, FOLDS)
    assert A.shape == (FOLDS, 8, 8)
    close(a, ja, RTOL, 1e-6)
    close(A, jA, RTOL, 1e-6)
    terms = ([torch.sum(t(ca) * a)] if wa else []) + ([torch.sum(t(cA) * A)] if wA else [])
    tv = sum(terms)
    close(tv, jv, RTOL, 1e-6)
    gK, gy = torch.autograd.grad(tv, [tK, ty])
    close(gK, jK, RTOL, _grad_atol(jK))
    close(gy, jy, RTOL, _grad_atol(jy) + 1e-12)


def test_kfold_solve_blocks_refuses_a_ragged_split():
    K, y = _spd(6, 30)
    with pytest.raises(ValueError):
        tlinalg.kfold_solve_blocks(t(K), t(y), FOLDS)
    with pytest.raises(ValueError):
        texact.kfold_exact_precision(t(K), t(y), 0.1, FOLDS)


def _sym(K):
    # The factor reads one triangle; gradcheck perturbs single entries, so the
    # input is symmetrized first and the check covers both triangles alike.
    return 0.5 * (K + K.T)


@pytest.mark.parametrize("core", ["loo", "kfold"])
def test_solve_cores_pass_float64_gradcheck(core):
    K, y = _spd(7, 12)
    K = torch.tensor(K, dtype=torch.float64, requires_grad=True)
    y = torch.tensor(y, dtype=torch.float64, requires_grad=True)
    if core == "loo":
        def f(K, y):
            return tlinalg.LooSolveDiag.apply(_sym(K), y)
    else:
        def f(K, y):
            return tlinalg.KfoldSolveBlocks.apply(_sym(K), y, 3)
    assert torch.autograd.gradcheck(f, (K, y), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_solve_cores_save_only_kinv_and_a():
    K, y = _spd(8, 16)
    tK = t(K).requires_grad_()
    for out in (tlinalg.loo_solve_diag(tK, t(y)), tlinalg.kfold_solve_blocks(tK, t(y), FOLDS)):
        saved = out[0].grad_fn.saved_tensors
        assert [tuple(s.shape) for s in saved] == [(16, 16), (16,)]
        close(saved[0], np.linalg.inv(K.astype(np.float64)), RTOL, 1e-5)


def test_symmetric_sqrt_matches_jax():
    K, _ = _spd(9, 20)
    got = tlinalg.symmetric_sqrt(t(K))
    close(got, jlinalg.symmetric_sqrt(jnp.asarray(K)), 1e-3, 1e-5)
    close(got @ got, K, 1e-4, 1e-5)


# ---- the exact model ---------------------------------------------------------


def test_exact_predictive_matches_jax_and_the_oracle():
    x, y, p = _exact_problem(seed=10)
    xs = np.random.default_rng(11).uniform(-1, 1, (20, 3)).astype(np.float32)
    k_ff, k_sf = _k_ff(x, p), oracle.ard_gram(xs, x, 0.3, p["log_length"]).astype(np.float32)
    k_ss = oracle.ard_gram(xs, xs, 0.3, p["log_length"]).astype(np.float32)
    noise = float(np.exp(p["log_noise_sq"]))
    got = texact.exact_predictive(t(k_sf), t(k_ff), t(k_ss), t(y), noise)
    want = jexact.exact_predictive(*(jnp.asarray(a) for a in (k_sf, k_ff, k_ss, y)), noise)
    close(got.mean, want.mean, RTOL, 1e-5)
    close(got.cov, want.cov, RTOL, 1e-5)
    om, oc = oracle.exact_predictive(k_sf.astype(np.float64), k_ff.astype(np.float64),
                                     k_ss.astype(np.float64), y.astype(np.float64), noise)
    close(got.mean, om, RTOL, 1e-4)  # fp32 against fp64: atol 1e-4
    close(got.cov, oc, RTOL, 1e-4)


def test_loo_exact_matches_jax_and_the_oracle():
    x, y, p = _exact_problem(seed=12)
    k_ff, noise = _k_ff(x, p), float(np.exp(p["log_noise_sq"]))
    got = texact.loo_exact(t(k_ff), t(y), noise)
    want = jexact.loo_exact(jnp.asarray(k_ff), jnp.asarray(y), noise)
    close(got.mean, want.mean, RTOL, 1e-5)
    close(got.cov, want.cov, RTOL, 1e-6)
    om, ov = oracle.loo_identity(k_ff.astype(np.float64), y.astype(np.float64), noise)
    close(got.mean, om, RTOL, 1e-4)  # fp32 against fp64: atol 1e-4
    close(got.cov, ov, 1e-3, 1e-5)


@pytest.mark.parametrize("diag_only", [False, True])
def test_kfold_exact_matches_jax_and_the_oracle(diag_only):
    x, y, p = _exact_problem(seed=13)
    k_ff, noise = _k_ff(x, p), float(np.exp(p["log_noise_sq"]))
    got = texact.kfold_exact(t(k_ff), t(y), noise, FOLDS, diag_only=diag_only)
    want = jexact.kfold_exact(jnp.asarray(k_ff), jnp.asarray(y), noise, FOLDS,
                              diag_only=diag_only)
    close(got.mean, want.mean, RTOL, 1e-5)
    close(got.cov, want.cov, RTOL, 1e-6)
    om, oc = oracle.kfold_conditionals(k_ff.astype(np.float64), y.astype(np.float64),
                                       noise, FOLDS)
    close(got.mean, om, 1e-3, 1e-4)  # fp32 against fp64: atol 1e-4
    close(got.cov, np.diagonal(oc, axis1=-2, axis2=-1) if diag_only else oc, 1e-3, 1e-5)


def test_kfold_exact_precision_matches_jax_and_the_oracle():
    x, y, p = _exact_problem(seed=14)
    k_ff, noise = _k_ff(x, p), float(np.exp(p["log_noise_sq"]))
    got = texact.kfold_exact_precision(t(k_ff), t(y), noise, FOLDS)
    want = jexact.kfold_exact_precision(jnp.asarray(k_ff), jnp.asarray(y), noise, FOLDS)
    close(got.mean, want.mean, RTOL, 1e-5)
    close(got.chol_prec, want.chol_prec, RTOL, 1e-5)
    om, oc = oracle.kfold_conditionals(k_ff.astype(np.float64), y.astype(np.float64),
                                       noise, FOLDS)
    close(got.mean, om, 1e-3, 1e-4)
    La = got.chol_prec.double()
    close(torch.linalg.inv(La @ La.mT), oc, 1e-3, 1e-5)


def test_nlml_exact_matches_jax_and_the_oracle():
    x, y, p = _exact_problem(seed=15)
    k_ff, noise = _k_ff(x, p), float(np.exp(p["log_noise_sq"]))
    got = texact.nlml_exact(t(k_ff), t(y), noise)
    close(got, jexact.nlml_exact(jnp.asarray(k_ff), jnp.asarray(y), noise), RTOL)
    close(got, oracle.nlml(k_ff.astype(np.float64), y.astype(np.float64), noise), RTOL)


def test_failed_fold_factor_is_nan_and_does_not_raise():
    """A non-SPD K_hat makes the exact fold objective NaN, as in JAX, so that
    fit_gd's masked update skips the step."""
    x, y, p = _exact_problem(seed=16, n=16)
    p = dict(p, log_noise_sq=np.float32(-30.0), log_length=np.full(3, 3.0, np.float32))
    for rule in ("dss", "kc", "crps"):
        value = make_objective(rule, model="exact")(torch_params(p), t(x), t(y))
        jvalue = jax.jit(jax_make_objective(rule, model="exact"))(
            jax_params(p), jnp.asarray(x), jnp.asarray(y), None)
        assert not np.isfinite(float(jvalue)) and not torch.isfinite(value), rule


# ---- block scoring rules -----------------------------------------------------


def _block(seed, n=12, folds=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((folds, n, n))
    cov = (a @ np.swapaxes(a, -1, -2) / n + 0.3 * np.eye(n)).astype(np.float32)
    mean = rng.standard_normal((folds, n)).astype(np.float32)
    y = rng.standard_normal((folds, n)).astype(np.float32)
    return mean, cov, y


def test_dss_matches_jax_and_the_oracle():
    mean, cov, y = _block(20)
    got = trules.dss(t(mean), t(cov), t(y))
    want = jax.vmap(jrules.dss)(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(y))
    close(got, want, RTOL)
    close(got, [oracle.dss(m, c, yy) for m, c, yy in zip(mean, cov, y)], RTOL, 1e-4)


def test_dss_precision_matches_jax_and_dss():
    mean, cov, y = _block(21)
    La = np.linalg.cholesky(np.linalg.inv(cov.astype(np.float64))).astype(np.float32)
    got = trules.dss_precision(t(mean), t(La), t(y))
    want = jax.vmap(jrules.dss_precision)(jnp.asarray(mean), jnp.asarray(La), jnp.asarray(y))
    close(got, want, RTOL)
    close(got, trules.dss(t(mean), t(cov), t(y)), 1e-3)


@pytest.mark.parametrize("sqrt_method", ["chol", "eigh"])
def test_energy_score_matches_jax_at_its_normals(sqrt_method):
    mean, cov, y = (a[0] for a in _block(22))
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda *a: jrules.energy_score(*a, num_sim=NUM_SIM, sqrt_method=sqrt_method))(
        key, jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(y))
    k1, k2 = jax.random.split(key)
    eps = tuple(t(jax.random.normal(k, (NUM_SIM, 12), jnp.float32)) for k in (k1, k2))
    got = trules.energy_score(t(mean), t(cov), t(y), NUM_SIM, sqrt_method=sqrt_method,
                              eps=eps)
    close(got, want, 1e-3 if sqrt_method == "eigh" else RTOL)
    with pytest.raises(ValueError):
        trules.energy_score(t(mean), t(cov), t(y), NUM_SIM, sqrt_method="svd", eps=eps)


def _jax_precision_eps(key, folds, nb, num_sim):
    """The normals the JAX exact es objective draws per fold from ``key``."""
    e, ep = [], []
    for k in jax.random.split(key, folds):
        k1, k2 = jax.random.split(k)
        e.append(np.asarray(jax.random.normal(k1, (nb, num_sim), jnp.float32)))
        ep.append(np.asarray(jax.random.normal(k2, (nb, num_sim), jnp.float32)))
    return t(np.stack(e)), t(np.stack(ep))


def test_energy_score_precision_matches_jax_at_its_normals():
    mean, cov, y = _block(23)
    La = np.linalg.cholesky(np.linalg.inv(cov.astype(np.float64))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    keys = jax.random.split(key, 3)
    want = jax.jit(jax.vmap(lambda k, m, L, yy: jrules.energy_score_precision(
        k, m, L, yy, num_sim=NUM_SIM)))(keys, jnp.asarray(mean), jnp.asarray(La), jnp.asarray(y))
    eps = _jax_precision_eps(key, 3, 12, NUM_SIM)
    got = trules.energy_score_precision(t(mean), t(La), t(y), NUM_SIM, eps=eps)
    close(got, want, RTOL)
    drawn = trules.energy_score_precision(t(mean), t(La), t(y), NUM_SIM,
                                          generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3,) and torch.isfinite(drawn).all()


# ---- the exact objectives ----------------------------------------------------


@pytest.mark.parametrize("kernel", ["ard", "rbf"])
@pytest.mark.parametrize("rule", OBJECTIVE_RULES)
def test_exact_objective_value_and_grad_match_jax(rule, kernel):
    x, y, p = _exact_problem(seed=30, n=48, d=3)
    if kernel == "rbf":
        p = dict(p, log_length=np.float32(-0.2))
    key = jax.random.PRNGKey(7)
    jloss = jax_make_objective(rule, model="exact", kernel=kernel, num_sim=NUM_SIM)
    want, jg = jax.jit(jax.value_and_grad(jloss))(jax_params(p), jnp.asarray(x),
                                                  jnp.asarray(y), key)
    eps = _jax_precision_eps(key, FOLDS, 48 // FOLDS, NUM_SIM) if rule == "es" else None
    tp = torch_params(p, requires_grad=True)
    got = make_objective(rule, model="exact", kernel=kernel, num_sim=NUM_SIM)(
        tp, t(x), t(y), eps=eps)
    close(got, want, RTOL)
    grads = torch.autograd.grad(got, list(tp.leaves().values()))
    for f, g in zip(tp.leaves(), grads):
        w = getattr(jg, f)
        close(g, w, RTOL, _grad_atol(w))


def test_exact_es_objective_draws_from_a_generator():
    x, y, p = _exact_problem(seed=31, n=32)
    loss = make_objective("es", model="exact", num_sim=NUM_SIM)
    a, b, c = (loss(torch_params(p), t(x), t(y), torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    assert torch.isfinite(a) and float(a) == float(b) and float(a) != float(c)


def test_exact_eval_predictive_metrics_match_jax():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from experiments.common import eval_predictive_metrics as jax_eval_metrics

    x, y, p = _exact_problem(seed=32, n=48)
    xs, ys, _ = _exact_problem(seed=33, n=40)
    want = jax.jit(lambda *a: jax_eval_metrics("exact", *a))(
        jax_params(p), jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs), jnp.asarray(ys))
    got = eval_predictive_metrics("exact", torch_params(p), t(x), t(y), t(xs), t(ys))
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), 1e-5, 1e-6)


def _old_safe_cholesky(A, ladder=(0.0, 1e-6, 1e-4, 1e-2)):
    """safe_cholesky as it was before ``batch_dims``: one rung for the whole stack."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype)
    scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)[..., None, None]
    L = tlinalg.chol_factor(A + ladder[0] * scale * eye)
    for frac in ladder[1:]:
        L = torch.where(torch.any(torch.isnan(L)), tlinalg.chol_factor(A + frac * scale * eye), L)
    return L, torch.logical_not(torch.any(torch.isnan(L)))


def _jitter_stack(n=5, seed=3):
    """[3, n, n]: SPD, the all-ones matrix (its factor fails without jitter
    and holds at the 1e-6 rung), SPD."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(3):
        X = rng.standard_normal((n, n)).astype(np.float32)
        spd = X @ X.T + n * np.eye(n, dtype=np.float32)
        mats.append(np.ones((n, n), np.float32) if i == 1 else spd)
    return np.stack(mats)


def test_safe_cholesky_takes_a_rung_per_batch_element_as_jax_vmap_does():
    """batch_dims=1: each element picks its own rung, as jax.vmap(safe_cholesky)
    does; each is bitwise its solo call, and ok is per element."""
    A = _jitter_stack()
    L, ok = tlinalg.safe_cholesky(t(A), batch_dims=1)
    jL, jok = jax.vmap(jlinalg.safe_cholesky)(jnp.asarray(A))
    assert ok.shape == (3,) and ok.tolist() == np.asarray(jok).tolist() == [True] * 3
    close(L, jL, 1e-5, 1e-6)
    for i in range(3):
        solo, solo_ok = tlinalg.safe_cholesky(t(A[i]))
        assert torch.equal(L[i], solo) and bool(solo_ok)
    # The healthy elements took no jitter: exactly their plain factors.
    assert torch.equal(L[0], tlinalg.chol_factor(t(A[0])))
    # A stack after the batch axes shares its element's rung: [2, 3, n, n].
    L2, ok2 = tlinalg.safe_cholesky(t(np.stack([A, A[::-1].copy()])), batch_dims=1)
    assert ok2.shape == (2,) and torch.equal(L2[0], _old_safe_cholesky(t(A))[0])


def test_safe_cholesky_by_default_takes_one_rung_for_the_stack():
    """batch_dims=0 is the function as it was, bit for bit: the whole stack
    takes the rung its worst element needs."""
    A = t(_jitter_stack())
    L, ok = tlinalg.safe_cholesky(A)
    L0, ok0 = _old_safe_cholesky(A)
    assert torch.equal(L, L0) and ok.shape == () and bool(ok) == bool(ok0)
    assert not torch.equal(L[0], tlinalg.chol_factor(A[0]))  # jittered with its neighbour


def test_energy_score_batch_dims_keeps_each_elements_rung():
    """energy_score(..., batch_dims=1) on a stack with one jittered element
    gives each element's solo score."""
    A = _jitter_stack(n=4)
    rng = np.random.default_rng(8)
    mean, y = (t(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(2))
    eps = tuple(t(rng.standard_normal((3, 16, 4)).astype(np.float32)) for _ in range(2))
    got = trules.energy_score(mean, t(A), y, num_sim=16, eps=eps, batch_dims=1)
    want = torch.stack([trules.energy_score(mean[i], t(A[i]), y[i], num_sim=16,
                                            eps=(eps[0][i], eps[1][i])) for i in range(3)])
    close(got, want.numpy(), 1e-6)
    shared = trules.energy_score(mean, t(A), y, num_sim=16, eps=eps)  # one rung: jittered
    assert not torch.equal(shared[0], want[0])
