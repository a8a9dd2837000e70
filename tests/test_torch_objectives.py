"""The port's objectives, scoring rules and metrics against gpscore's.

Every FITC objective, value and gradient at fixed parameters, rtol 1e-4; the
energy score with the JAX package's own normal draws handed across.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.fit import make_objective as jax_make_objective
from gpscore.metrics import evaluate_predictive as jax_evaluate
from gpscore.scoring import rules as jrules
from gpscore_torch.experiments.common import run_sweep
from gpscore_torch.fit import OBJECTIVE_RULES, eval_predictive_metrics, make_objective
from gpscore_torch.fit import objectives as tobjectives
from gpscore_torch.fit.schedules import Schedule
from gpscore_torch.metrics import evaluate_predictive
from gpscore_torch.scoring import rules as trules
from torch_parity import close, jax_fold_eps, jax_params, problem, t, torch_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from experiments.common import eval_predictive_metrics as jax_eval_metrics  # noqa: E402

RTOL = 1e-4
NUM_SIM = 32
FOLDS = 4


def _grad_atol(w):
    return RTOL * float(np.max(np.abs(np.asarray(w))))


def _es_eps(key, n, m):
    k_z, k_zp = jax.random.split(key)
    return (jax_fold_eps(k_z, FOLDS, n // FOLDS, m, NUM_SIM),
            jax_fold_eps(k_zp, FOLDS, n // FOLDS, m, NUM_SIM))


@pytest.mark.parametrize("rule", OBJECTIVE_RULES)
def test_fitc_objective_value_and_grad_match_jax(rule):
    x, y, p = problem(seed=1, n=64, m=6, d=3)
    key = jax.random.PRNGKey(3)
    jloss = jax_make_objective(rule, model="fitc", num_sim=NUM_SIM)
    want, jg = jax.jit(jax.value_and_grad(jloss))(jax_params(p), jnp.asarray(x),
                                                  jnp.asarray(y), key)
    tp = torch_params(p, requires_grad=True)
    eps = _es_eps(key, x.shape[0], p["inducing"].shape[0]) if rule == "es" else None
    got = make_objective(rule, model="fitc", num_sim=NUM_SIM)(tp, t(x), t(y), eps=eps)
    close(got, want, RTOL)
    grads = torch.autograd.grad(got, list(tp.leaves().values()))
    for f, g in zip(tp.leaves(), grads):
        w = getattr(jg, f)
        close(g, w, RTOL, _grad_atol(w))


def test_rbf_kernel_objective_matches_jax():
    """The isotropic kernel (scalar log squared length) through the ARD kernel."""
    x, y, p = problem(seed=2, n=32, m=4, d=2)
    p = dict(p, log_length=np.float32(-0.2))
    want, jg = jax.value_and_grad(jax_make_objective("crps", model="fitc", kernel="rbf"))(
        jax_params(p), jnp.asarray(x), jnp.asarray(y), None)
    tp = torch_params(p, requires_grad=True)
    got = make_objective("crps", model="fitc", kernel="rbf")(tp, t(x), t(y))
    close(got, want, RTOL)
    (g_len,) = torch.autograd.grad(got, [tp.log_length])
    close(g_len, jg.log_length, RTOL, 1e-7)


def test_es_objective_draws_from_a_generator():
    x, y, p = problem(seed=3, n=32, m=4, d=2)
    loss = make_objective("es", model="fitc", num_sim=NUM_SIM)
    a = loss(torch_params(p), t(x), t(y), torch.Generator().manual_seed(0))
    b = loss(torch_params(p), t(x), t(y), torch.Generator().manual_seed(0))
    c = loss(torch_params(p), t(x), t(y), torch.Generator().manual_seed(1))
    assert torch.isfinite(a) and float(a) == float(b) and float(a) != float(c)


def test_make_objective_refuses_what_is_not_ported(monkeypatch):
    """No exact rule raises ``NotImplementedError`` at any n: with the fused
    threshold lowered the fold rules dss, es and kc run the fold-streamed
    cores and match the dense path (es at the same normals; the LOO rules
    and nlml are in tests/test_torch_large_n.py). An unknown rule or model
    is refused."""
    x, y, p = problem(seed=4, n=64, d=3)
    gen = torch.Generator().manual_seed(0)
    eps = tuple(torch.randn((FOLDS, 64 // FOLDS, NUM_SIM), generator=gen) for _ in range(2))
    for rule in ("dss", "es", "kc"):
        loss = make_objective(rule, model="exact", fold_k=FOLDS, num_sim=NUM_SIM, block=24)
        dense = loss(torch_params(p), t(x), t(y), eps=eps)
        monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
        close(loss(torch_params(p), t(x), t(y), eps=eps), dense.numpy(), RTOL)
        monkeypatch.undo()
    with pytest.raises(ValueError):
        make_objective("brier", model="fitc")
    with pytest.raises(ValueError):
        make_objective("crps", model="sgpr")


# ---- scoring rules -----------------------------------------------------------


def _moments(seed, shape):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(shape).astype(np.float32)
    var = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    return mean, var, y


@pytest.mark.parametrize("name", ["crps_gaussian", "logs_gaussian", "interval_score"])
def test_pointwise_rules_match_jax(name):
    m, v, y = _moments(4, (50,))
    want = getattr(jrules, name)(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y))
    close(getattr(trules, name)(t(m), t(v), t(y)), want, 1e-5)


def test_crps_kfold_matches_jax():
    m, v, y = _moments(5, (4, 16))
    want = jrules.crps_kfold(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y))
    close(trules.crps_kfold(t(m), t(v), t(y)), want, 1e-5)


def test_energy_score_core_matches_jax_per_fold():
    rng = np.random.default_rng(6)
    z, zp = (rng.standard_normal((3, 20, 7)).astype(np.float32) for _ in range(2))
    r = rng.standard_normal((3, 7)).astype(np.float32)
    for beta in (1.0, 1.5):
        want = jax.vmap(lambda a, b, c: jrules.energy_score_core(a, b, c, 20, beta))(
            jnp.asarray(z), jnp.asarray(zp), jnp.asarray(r))
        close(trules.energy_score_core(t(z), t(zp), t(r), 20, beta), want, 1e-5)


def test_safe_norm_pow_has_a_finite_gradient_at_zero():
    sq = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(trules._safe_norm_pow(sq, 1.0).sum(), [sq])
    assert torch.isfinite(g).all()


# ---- metrics -----------------------------------------------------------------


def test_evaluate_predictive_matches_jax():
    m, v, y = _moments(7, (40,))
    y_train = np.random.default_rng(8).standard_normal(30).astype(np.float32)
    want = jax_evaluate(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y), jnp.asarray(y_train))
    got = evaluate_predictive(t(m), t(v), t(y), t(y_train))
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), 1e-5, 1e-7)


def test_eval_predictive_metrics_matches_jax():
    x, y, p = problem(seed=9, n=64, m=6, d=3)
    xs, ys, _ = problem(seed=10, n=40, m=6, d=3)
    want = jax_eval_metrics("fitc", jax_params(p), jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(xs), jnp.asarray(ys))
    got = eval_predictive_metrics("fitc", torch_params(p), t(x), t(y), t(xs), t(ys))
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), 1e-5, 1e-6)
    # The evaluation runs in "highest" whatever the mode around it, and the
    # sweep takes every mode for its fits (an unknown one raises).
    from gpscore_torch.utils.precision import matmul_mode

    with matmul_mode("fast"):
        again = eval_predictive_metrics("fitc", torch_params(p), t(x), t(y), t(xs), t(ys))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    for mode in ("high", "bf16"):
        res = run_sweep(["crps"], "fitc", {"crps": Schedule("crps", 1, 1.0)},
                        lambda j: (x, y, xs, ys), lambda g, d: torch_params(p), replicates=1,
                        d=3, matmul=mode, device="cpu", verbose=False)
        assert res["crps"]["num_failed"] == 0 and np.isfinite(res["crps"]["crps"])
    with pytest.raises(ValueError):
        run_sweep(["crps"], "fitc", {"crps": Schedule("crps", 1, 1.0)},
                  lambda j: (x, y, xs, ys), lambda g, d: torch_params(p), replicates=1, d=3,
                  matmul="tf32", device="cpu")
