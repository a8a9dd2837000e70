"""The port's fit_gd against gpscore's: 25-step loss histories of every bench
rule (rtol 1e-4), and the NaN-masked update with its stall counter; the
static-buffer step against the functional loop written out here, bit for bit;
fit_optim against gpscore's fit_optax (loss rtol 1e-5, parameters 1e-4), and
max_reduce against gpscore's.

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
import optax
import pytest
import torch

from gpscore.fit import fit_gd as jax_fit_gd
from gpscore.fit import make_objective as jax_make_objective
from gpscore.fit.train import fit_optax as jax_fit_optax
from gpscore.fit.train import max_reduce as jax_max_reduce
from gpscore_torch.fit import (SCHEDULES, fit_and_eval, fit_gd, fit_optim, make_objective,
                               max_reduce)
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


# ---- the static-buffer step against the functional loop ----------------------


def _functional_loop(loss_fn, params, x, y, iters, lr, lr_inducing, skip_nonfinite=True):
    """Gradient descent with fresh tensors every step and list histories: the
    arithmetic fit_gd's in-place step must reproduce bit for bit. Returns
    (final leaves, losses, parameter lists, stall)."""
    leaves = {f: v.detach() for f, v in params.leaves().items()}
    losses, history, stall = [], {f: [] for f in leaves}, 0
    for _ in range(iters):
        cur = {f: v.detach().requires_grad_() for f, v in leaves.items()}
        loss = loss_fn(params.replace(**cur), x, y, None)
        grads = torch.autograd.grad(loss, list(cur.values()))
        with torch.no_grad():
            probe = torch.abs(loss)
            for g in grads:
                probe = torch.maximum(probe, torch.max(torch.abs(g)))
            finite = bool(torch.isfinite(probe))
            stall = 0 if finite else stall + 1
            new = {}
            for (f, v), g in zip(cur.items(), grads):
                upd = v - (lr_inducing if f == "inducing" else lr) * g
                new[f] = upd if finite or not skip_nonfinite else v.detach()
            losses.append(loss.detach())
            for f, v in cur.items():
                history[f].append(v.detach())
        leaves = new
    return leaves, torch.stack(losses), {f: torch.stack(h) for f, h in history.items()}, stall


@pytest.fixture(scope="module")
def small():
    return problem(seed=3, n=48, m=6, d=3)


@pytest.mark.parametrize("fail_at", [(), (2, 5), (8, 9)], ids=["healthy", "failed-mid", "stalled"])
@pytest.mark.parametrize("model,rule", [("fitc", r) for r in BENCH_RULES]
                         + [("exact", "crps"), ("exact", "dss")])
def test_static_buffer_step_equals_the_functional_loop(small, model, rule, fail_at):
    """Loss history, parameter history, final parameters and stall_iters of
    fit_gd, equal bit for bit (NaNs at the same places) to the functional
    loop's, at n = 48 over 10 steps, with and without failed steps."""
    x, y, p = small
    if model == "exact":
        p = {f: v for f, v in p.items() if f != "inducing"}
        sched = SCHEDULES[("kin40k_full", rule)]
    else:
        sched = SCHEDULES[("kin40k_fitc", rule)]
    objective = make_objective(rule, model=model)
    lr = sched.lr * 0.1  # a tenth of the n = 500 rate: finite throughout at n = 48
    lr_u = None if sched.lr_inducing is None else sched.lr_inducing * 0.1
    got = fit_gd(_failing_at(objective, set(fail_at)), torch_params(p), t(x), t(y), 10, lr, lr_u,
                 record_params=True)
    leaves, losses, history, stall = _functional_loop(
        _failing_at(objective, set(fail_at)), torch_params(p), t(x), t(y), 10, lr,
        lr if lr_u is None else lr_u)
    assert torch.isnan(losses).nonzero().flatten().tolist() == list(fail_at)
    np.testing.assert_array_equal(got.loss_history.numpy(), losses.numpy())
    for f, want in leaves.items():
        np.testing.assert_array_equal(getattr(got.params, f).numpy(), want.numpy())
        np.testing.assert_array_equal(getattr(got.param_history, f).numpy(), history[f].numpy())
    assert int(got.stall_iters) == stall == (2 if fail_at == (8, 9) else 0)
    assert not any(v.requires_grad for v in got.params.leaves().values())


def test_fit_gd_leaves_the_callers_parameters_alone(small):
    x, y, p = small
    p0 = torch_params(p)
    before = {f: v.clone() for f, v in p0.leaves().items()}
    fit_gd(make_objective("nlml", model="fitc"), p0, t(x), t(y), 3, 1e-3)
    for f, v in p0.leaves().items():
        assert torch.equal(v, before[f]) and not v.requires_grad


def test_graph_true_on_cpu_raises_and_the_default_on_cpu_is_eager(small):
    x, y, p = small
    loss = make_objective("nlml", model="fitc")
    with pytest.raises(ValueError, match="CUDA graph"):
        fit_gd(loss, torch_params(p), t(x), t(y), 3, 1e-3, graph=True)
    with pytest.raises(ValueError, match="CUDA graph"):
        fit_optim(loss, torch_params(p), t(x), t(y), 3,
                  lambda ps: torch.optim.SGD(ps, lr=1e-3), graph=True)
    # 20 iterations: over the capture minimum, and still eager on the CPU.
    default = fit_gd(loss, torch_params(p), t(x), t(y), 20, 1e-3)
    eager = fit_gd(loss, torch_params(p), t(x), t(y), 20, 1e-3, graph=False)
    assert torch.equal(default.loss_history, eager.loss_history)


# ---- fit_optim and max_reduce against the JAX package -------------------------


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_fit_optim_matches_fit_optax(prob, name):
    """20 steps of the FITC nlml fit from the same numpy inputs and initial
    parameters: loss history rtol 1e-5, final parameters rtol 1e-4 (atol that
    of the leaf's largest entry)."""
    x, y, p = prob
    lr = {"sgd": 1e-3, "adam": 1e-2}[name]
    want = jax_fit_optax(jax_make_objective("nlml", model="fitc"), jax_params(p), jnp.asarray(x),
                         jnp.asarray(y), 20, getattr(optax, name)(lr))
    make = {"sgd": lambda ps: torch.optim.SGD(ps, lr=lr),
            "adam": lambda ps: torch.optim.Adam(ps, lr=lr)}[name]
    got = fit_optim(make_objective("nlml", model="fitc"), torch_params(p), t(x), t(y), 20, make)
    close(got.loss_history, want.loss_history, 1e-5)
    got_p = params_to_numpy(got.params)
    for f in got_p:
        w = np.asarray(getattr(want.params, f))
        close(got_p[f], w, 1e-4, 1e-4 * float(np.abs(w).max()))
    assert bool(got.ok) and got.param_history is None and got.stall_iters is None
    assert float(got.loss_history[-1]) < float(got.loss_history[0])
    assert all(v.grad is None and not v.requires_grad for v in got.params.leaves().values())


@pytest.mark.parametrize("values", [[1.0], [1.0, 3.0, 2.0], [1.0, float("nan"), 2.0],
                                    [float("nan"), 1.0], [1.0, float("inf")],
                                    [float("inf"), float("nan")], [-float("inf"), -2.0]])
def test_max_reduce_matches_jax(values):
    got = max_reduce([torch.tensor(v) for v in values])
    want = jax_max_reduce([jnp.float32(v) for v in values])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- fit_gd_recovering: the precision-mode recovery ladder ----------------------
# Mirrors tests/test_fit.py::TestStallRecovery case by case. The stall is a
# toy objective that reads the precision mode as the step runs and goes NaN
# past a parameter threshold in the 2-byte modes only, as the large-n cores'
# factorizations do once the lengthscales grow.


def _recovery_params(lib):
    if lib == "jax":
        from gpscore.utils.params import GPParams as JaxParams

        return JaxParams(jnp.float32(0.0), jnp.ones((1,), jnp.float32), jnp.float32(1.0))
    return torch_params({"log_signal_sq": np.float32(0.0),
                         "log_length": np.ones((1,), np.float32),
                         "log_noise_sq": np.float32(1.0), "inducing": None})


def _stalling_loss(modes=("bf16", "f16")):
    from gpscore_torch.utils.precision import get_matmul_mode

    def loss(params, x, y, generator=None):
        # The other leaves enter with weight 0: autograd.grad wants every leaf used.
        base = (params.log_signal_sq - 1.0) ** 2 + 0.0 * (
            params.log_length.sum() + params.log_noise_sq)
        if get_matmul_mode() in modes:
            base = torch.where(params.log_signal_sq > 0.55, torch.full_like(base, float("nan")),
                               base)
        return base

    return loss


def _jax_stalling_loss(params, x, y, key=None):
    from gpscore.utils.precision import get_matmul_mode

    base = (params.log_signal_sq - 1.0) ** 2
    if get_matmul_mode() in ("bf16", "f16"):
        base = jnp.where(params.log_signal_sq > 0.55, jnp.nan, base)
    return base


def _data():
    return torch.zeros((16, 1)), torch.zeros(16)


def test_stall_iters_counts_trailing_skips():
    from gpscore_torch.utils.precision import matmul_mode

    x, y = _data()
    with matmul_mode("f16"):
        res = fit_gd(_stalling_loss(), _recovery_params("torch"), x, y, 8, 0.25)
    # 0 -> 0.5 (finite) -> 0.75 -> NaN, frozen for the rest.
    assert int(res.stall_iters) == 6
    close(res.params.log_signal_sq, 0.75, 1e-6)
    res2 = fit_gd(_stalling_loss(), _recovery_params("torch"), x, y, 8, 0.25)
    assert int(res2.stall_iters) == 0


def test_fit_gd_recovering_completes_as_jax_does():
    from gpscore.fit import fit_gd_recovering as jax_recovering
    from gpscore.utils.precision import matmul_mode as jax_matmul_mode
    from gpscore_torch.fit import fit_gd_recovering
    from gpscore_torch.utils.precision import matmul_mode

    x, y = _data()
    with matmul_mode("f16"):
        res, info = fit_gd_recovering(_stalling_loss(), _recovery_params("torch"), x, y, 8, 0.25)
    with jax_matmul_mode("f16"):
        want, want_info = jax_recovering(_jax_stalling_loss, _recovery_params("jax"),
                                         jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), 8, 0.25)
    # The auto ladder at small n: f16 -> high; the 6 lost iterations re-run.
    assert info["stall_iters"] == want_info["stall_iters"] == 6
    assert info["recovery"] == want_info["recovery"] == [
        {"mode": "high", "iters": 6, "stall_after": 0}]
    assert [s["mode"] for s in info["segments"]] == ["f16", "high"]
    assert int(res.stall_iters) == 0 and res.loss_history.shape == (8,)
    assert torch.isfinite(res.loss_history).all() and bool(res.ok)
    close(res.loss_history, want.loss_history, 1e-6, 1e-7)
    close(res.params.log_signal_sq, want.params.log_signal_sq, 1e-6)
    assert float(res.params.log_signal_sq) > 0.95


def test_fit_gd_recovering_no_stall_is_single_leg():
    from gpscore_torch.fit import fit_gd_recovering

    x, y = _data()
    res, info = fit_gd_recovering(_stalling_loss(), _recovery_params("torch"), x, y, 5, 0.25)
    assert info["stall_iters"] == 0 and info["recovery"] == [] and len(info["segments"]) == 1
    assert float(res.params.log_signal_sq) > 0.9


def test_auto_recover_mode_ladder():
    from gpscore_torch.fit import auto_recover_mode
    from gpscore_torch.fit.train import _FP32_STORAGE_CEILING_N

    above = _FP32_STORAGE_CEILING_N["loo"] + 8192
    assert auto_recover_mode("bf16", 30_720) == "high"
    assert auto_recover_mode("bf16", above) == "f16"
    assert auto_recover_mode("f16", 30_720) == "high"
    assert auto_recover_mode("f16", above) is None  # nothing safer
    assert auto_recover_mode("highest", 30_720) is None
    assert auto_recover_mode("fast", 30_720) is None


def test_auto_recover_mode_fold_family(monkeypatch):
    """In a gap where the fold rules' fp32 buffers no longer fit and the LOO
    rules' still do, the fold family falls to "f16", not to a "high" that
    would run out of memory."""
    from gpscore_torch.fit import auto_recover_mode, objective_family
    from gpscore_torch.fit import train as train_mod

    monkeypatch.setattr(train_mod, "_FP32_STORAGE_CEILING_N", {"loo": 61_440, "fold": 59_392})
    lo, hi = 59_392, 61_440
    gap_n = lo + 1024
    assert lo < gap_n <= hi
    assert auto_recover_mode("bf16", gap_n, "fold") == "f16"
    assert auto_recover_mode("f16", gap_n, "fold") is None
    assert auto_recover_mode("bf16", lo, "fold") == "high"
    assert auto_recover_mode("bf16", gap_n, "loo") == "high"
    assert [objective_family(r) for r in ("dss", "es", "kc", "crps", None)] == [
        "fold", "fold", "fold", "loo", "loo"]


def test_fold_rule_stall_recovers_via_f16_in_the_gap(monkeypatch):
    from gpscore_torch.fit import fit_gd_recovering
    from gpscore_torch.fit import train as train_mod
    from gpscore_torch.utils.precision import matmul_mode

    x, y = _data()
    n = x.shape[0]
    monkeypatch.setattr(train_mod, "_FP32_STORAGE_CEILING_N", {"loo": 10 * n, "fold": n // 2})
    with matmul_mode("bf16"):
        res, info = fit_gd_recovering(_stalling_loss(("bf16",)), _recovery_params("torch"), x, y,
                                      8, 0.25, rule="dss")
    assert info["recovery"] == [{"mode": "f16", "iters": 6, "stall_after": 0}]
    assert float(res.params.log_signal_sq) > 0.95


@pytest.mark.parametrize("error", ["oom", "other"])
def test_a_recovery_leg_out_of_memory_falls_to_f16_and_other_errors_propagate(monkeypatch,
                                                                              error):
    """A "high" leg that runs out of device memory is recorded and the ladder
    falls to "f16"; any other error of a leg propagates (the JAX function
    catches every RuntimeError there)."""
    from gpscore_torch.fit import fit_gd_recovering
    from gpscore_torch.fit import train as train_mod
    from gpscore_torch.utils.precision import get_matmul_mode, matmul_mode

    real_fit_gd = train_mod.fit_gd

    def fit_gd_high_fails(loss_fn, params, *a, **kw):
        if get_matmul_mode() == "high":
            if error == "oom":
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate ...")
            raise RuntimeError("cuBLAS failure")
        return real_fit_gd(loss_fn, params, *a, **kw)

    monkeypatch.setattr(train_mod, "fit_gd", fit_gd_high_fails)
    x, y = _data()
    with matmul_mode("bf16"):
        if error == "other":
            with pytest.raises(RuntimeError, match="cuBLAS failure"):
                fit_gd_recovering(_stalling_loss(("bf16",)), _recovery_params("torch"), x, y,
                                  8, 0.25)
            return
        res, info = fit_gd_recovering(_stalling_loss(("bf16",)), _recovery_params("torch"), x,
                                      y, 8, 0.25)
    assert info["recovery"][0]["mode"] == "high" and info["recovery"][0]["iters"] == 0
    assert "out of memory" in info["recovery"][0]["error"]
    assert info["recovery"][1] == {"mode": "f16", "iters": 6, "stall_after": 0}
    assert "unrecovered_iters" not in info
    assert float(res.params.log_signal_sq) > 0.95


def test_an_unrecoverable_stall_is_reported():
    """An explicit recover_mode that stalls too leaves unrecovered_iters."""
    from gpscore_torch.fit import fit_gd_recovering
    from gpscore_torch.utils.precision import matmul_mode

    x, y = _data()
    with matmul_mode("bf16"):
        res, info = fit_gd_recovering(_stalling_loss(), _recovery_params("torch"), x, y, 8,
                                      0.25, recover_mode="f16")
    assert info["recovery"] == [{"mode": "f16", "iters": 6, "stall_after": 6}]
    assert info["unrecovered_iters"] == 6 and int(res.stall_iters) == 6
