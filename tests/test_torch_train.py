"""The port's fit_gd against gpscore's: 25-step loss histories of every bench
rule (rtol 1e-4), and the NaN-masked update with its stall counter.

The problem (seed 1, n = 128, m = 8, d = 3) is one on which 25 steps at the
reference learning rates stay away from unstable transients, so that the
comparison tests the code and not the amplification of fp32 rounding by the
dynamics (on other seeds the logs and dss histories part by 1e-3..1e-1
within 25 steps while values and gradients at equal parameters agree to
fp32 grade).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.fit import fit_gd as jax_fit_gd
from gpscore.fit import make_objective as jax_make_objective
from gpscore_torch.fit import SCHEDULES, fit_and_eval, fit_gd, make_objective
from gpscore_torch.fit.schedules import Schedule
from gpscore_torch.ops import linalg
from gpscore_torch.utils.params import params_to_numpy
from torch_parity import close, jax_params, problem, t, torch_params

BENCH_RULES = ["crps", "nlml", "logs", "dss", "kc"]
STEPS = 25


@pytest.fixture(scope="module")
def prob():
    return problem(seed=1, n=128, m=8, d=3)


@pytest.mark.parametrize("rule", BENCH_RULES)
def test_fit_gd_history_matches_jax(prob, rule):
    x, y, p = prob
    sched = SCHEDULES[("kin40k_fitc", rule)]
    loss = jax_make_objective(rule, model="fitc")
    want = jax.jit(lambda q, x, y: jax_fit_gd(loss, q, x, y, STEPS, sched.lr,
                                              sched.lr_inducing))(
        jax_params(p), jnp.asarray(x), jnp.asarray(y))
    got = fit_gd(make_objective(rule, model="fitc"), torch_params(p), t(x), t(y), STEPS,
                 sched.lr, sched.lr_inducing)
    close(got.loss_history, want.loss_history, 1e-4)
    got_p = params_to_numpy(got.params)
    for f in got_p:
        w = getattr(want.params, f)
        close(got_p[f], w, 1e-4, 1e-4 * float(np.abs(np.asarray(w)).max()))
    assert bool(got.ok) and int(got.stall_iters) == int(want.stall_iters) == 0


def _failing_at(loss_fn, steps_to_fail):
    """Wrap ``loss_fn`` so that the calls numbered in ``steps_to_fail`` run a
    Cholesky of a non-SPD matrix into the loss, as a conditioning failure
    would: the loss and every gradient become NaN."""
    calls = {"n": 0}

    def loss(params, x, y, generator=None, eps=None):
        value = loss_fn(params, x, y)
        i = calls["n"]
        calls["n"] += 1
        if i in steps_to_fail:
            bad = -torch.eye(2) * params.signal_sq
            value = value + linalg.half_logdet(linalg.chol_factor(bad))
        return value

    return loss


@pytest.mark.parametrize("fail_at", [(3,), (STEPS - 2, STEPS - 1)])
def test_failed_cholesky_skips_the_update_and_counts_the_stall(prob, fail_at):
    x, y, p = prob
    loss = _failing_at(make_objective("crps", model="fitc"), set(fail_at))
    res = fit_gd(loss, torch_params(p), t(x), t(y), STEPS, 0.1, record_params=True)
    hist = res.loss_history
    assert torch.isnan(hist[list(fail_at)]).all()
    assert torch.isfinite(hist[[i for i in range(STEPS) if i not in fail_at]]).all()
    ph = res.param_history
    for i in fail_at:
        nxt = res.params if i == STEPS - 1 else ph.replace(
            **{f: v[i + 1] for f, v in ph.leaves().items()})
        for f, v in ph.leaves().items():
            assert torch.equal(getattr(nxt, f), v[i]), (i, f)  # update skipped
    trailing = len(fail_at) if fail_at[-1] == STEPS - 1 else 0
    assert int(res.stall_iters) == trailing
    assert bool(res.ok)


def test_nonfinite_update_applies_when_masking_is_off(prob):
    x, y, p = prob
    loss = _failing_at(make_objective("crps", model="fitc"), {2})
    res = fit_gd(loss, torch_params(p), t(x), t(y), 4, 0.1, skip_nonfinite=False)
    assert torch.isnan(res.params.log_signal_sq)


def test_record_params_is_the_pre_update_point(prob):
    x, y, p = prob
    loss = make_objective("nlml", model="fitc")
    res = fit_gd(loss, torch_params(p), t(x), t(y), 3, 1e-3, 1e-2, record_params=True)
    assert res.param_history.inducing.shape == (3, 8, 3)
    close(res.param_history.log_length[0], p["log_length"], 0)
    for i in range(3):
        at = {f: v[i] for f, v in res.param_history.leaves().items()}
        close(res.loss_history[i], loss(torch_params(p).replace(**at), t(x), t(y)), 1e-6)


def test_inducing_points_take_their_own_learning_rate(prob):
    x, y, p = prob
    loss = make_objective("nlml", model="fitc")
    base = fit_gd(loss, torch_params(p), t(x), t(y), 1, 1e-3, 1e-3)
    fast = fit_gd(loss, torch_params(p), t(x), t(y), 1, 1e-3, 1e-2)
    close(fast.params.log_length, base.params.log_length.numpy(), 0)
    d_base = base.params.inducing - t(p["inducing"])
    d_fast = fast.params.inducing - t(p["inducing"])
    close(d_fast, (10 * d_base).numpy(), 1e-3, 1e-9)


def test_fit_and_eval_runs_the_fitc_slice(prob):
    x, y, p = prob
    xs, ys, _ = problem(seed=2, n=40, m=8, d=3)
    metrics, res = fit_and_eval("crps", "fitc", Schedule("crps", 5, 1.0, 1.0),
                                torch_params(p), t(x), t(y), t(xs), t(ys))
    assert res.loss_history.shape == (5,)
    assert all(torch.isfinite(getattr(metrics, f)) for f in metrics._fields)
