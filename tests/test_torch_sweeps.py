"""The port's batched fits (a leading restart or replicate axis) against its
unbatched calls and against ``jax.vmap`` of gpscore's.

- The batched models and objectives equal a loop of unbatched calls: values
  to rtol 1e-6 (atol 1e-6 of the largest entry), gradients to 1e-4 of each
  leaf's largest entry. The arithmetic is the same, batched, but the batched
  products (bmm and the batched triangular solves) sum in another order than
  the unbatched ones, and the backward through the Cholesky factors
  amplifies that: the values read up to 9.2e-7 of their largest entry, the
  gradients up to 2.6e-5 of theirs (loo_fitc's);
- against ``jax.vmap`` of the JAX functions at the tolerances of the
  unbatched parity tests (tests/test_torch_fitc.py, tests/test_torch_exact.py:
  values rtol 1e-5 and 1e-4, gradients rtol 1e-4);
- ``restart_sweep`` against ``gpscore.parallel.restart_sweep``, 3 restarts x 5
  iterations: loss histories and final parameters at the tolerances of
  tests/test_torch_train.py (rtol 1e-4), ``ok`` and ``stall_iters`` equal;
- a restart whose Cholesky fails leaves the others bit for bit as in the
  sweep without the failure, and within rtol 1e-5 of their solo fits;
- ``multi_restart`` and the batched ``run_sweep`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.fit import make_objective as jax_make_objective
from gpscore.models import exact as jexact
from gpscore.models import fitc as jfitc
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.parallel import restart_sweep as jax_restart_sweep
from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.experiments import common, multi_restart
from gpscore_torch.fit import (SCHEDULES, fit_and_eval, fit_and_eval_batch, fit_gd,
                               fit_gd_batch, make_objective, objectives)
from gpscore_torch.fit.schedules import Schedule
from gpscore_torch.models import exact as texact
from gpscore_torch.models import fitc as tfitc
from gpscore_torch.ops import linalg
from gpscore_torch.ops.kernels import gram
from gpscore_torch.parallel import default_sweep_generator, restart_sweep
from gpscore_torch.utils.params import (FIELDS, batch_size, init_rand_params, params_from_numpy,
                                        select_params, stack_params)
from torch_parity import close, jax_fold_eps, problem, t

R = 3
FOLDS = 4


def _batch(seed=0, n=32, m=5, d=3, exact=False):
    """x, y and R parameter sets (numpy, leaves [R, ...]) around the parity
    problem's: restart r scales the log lengths and shifts the scalars."""
    x, y, p = problem(seed=seed, n=n, m=m, d=d)
    rng = np.random.default_rng(seed + 100)
    pb = {
        "log_signal_sq": np.array([p["log_signal_sq"] + 0.2 * r for r in range(R)], np.float32),
        "log_length": np.stack([p["log_length"] * (1 + 0.3 * r) for r in range(R)]).astype(
            np.float32),
        "log_noise_sq": np.array([p["log_noise_sq"] - 0.3 * r for r in range(R)], np.float32),
        "inducing": None if exact else np.stack(
            [p["inducing"] + 0.1 * rng.standard_normal(p["inducing"].shape)
             for _ in range(R)]).astype(np.float32),
    }
    return x, y, pb


def _tp(pb, requires_grad=False):
    p = params_from_numpy(pb)
    if requires_grad:
        p = p.replace(**{f: v.requires_grad_() for f, v in p.leaves().items()})
    return p


def _jp(pb):
    return JaxParams(**{f: None if pb.get(f) is None else jnp.asarray(pb[f]) for f in FIELDS})


def _rel_close(got, want, rtol):
    """rtol of each entry, with atol rtol of the largest entry."""
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor) else want)
    close(got, want, rtol, rtol * max(float(np.abs(want).max()), 1e-30))


# ---- batched models against their unbatched calls and jax.vmap ---------------


def _k_ff_t(x, p):
    return gram(x, x, p.log_signal_sq, p.log_length)


def _k_ff_j(x, p):
    return jax_ard_gram(x, x, p.log_signal_sq, p.log_length)


# name -> (port function of (x, y, params), JAX function of (x, y, params), exact?)
MODELS = {
    "fitc_terms": (lambda x, y, p: tuple(tfitc.fitc_terms(x, p)),
                   lambda x, y, p: tuple(jfitc.fitc_terms(x, p)), False),
    "loo_fitc": (lambda x, y, p: tuple(tfitc.loo_fitc(x, y, p, variance_correction=True)),
                 lambda x, y, p: tuple(jfitc.loo_fitc(x, y, p, variance_correction=True)),
                 False),
    "nlml_fitc": (lambda x, y, p: (tfitc.nlml_fitc(x, y, p),),
                  lambda x, y, p: (jfitc.nlml_fitc(x, y, p),), False),
    "kfold_fitc_lowrank": (lambda x, y, p: tuple(tfitc.kfold_fitc_lowrank(x, y, p, FOLDS)),
                           lambda x, y, p: tuple(jfitc.kfold_fitc_lowrank(x, y, p, FOLDS)),
                           False),
    "loo_exact": (lambda x, y, p: tuple(texact.loo_exact(_k_ff_t(x, p), y, p.noise_sq)),
                  lambda x, y, p: tuple(jexact.loo_exact(_k_ff_j(x, p), y, p.noise_sq)), True),
    "kfold_exact_precision": (
        lambda x, y, p: tuple(texact.kfold_exact_precision(_k_ff_t(x, p), y, p.noise_sq, FOLDS)),
        lambda x, y, p: tuple(jexact.kfold_exact_precision(_k_ff_j(x, p), y, p.noise_sq,
                                                           FOLDS)), True),
    "nlml_exact": (lambda x, y, p: (texact.nlml_exact(_k_ff_t(x, p), y, p.noise_sq),),
                   lambda x, y, p: (jexact.nlml_exact(_k_ff_j(x, p), y, p.noise_sq),), True),
}


def _scalarize(outs, weights):
    """A scalar of every output (weighted sums), for a gradient through all."""
    return sum(torch.sum(o * w) for o, w in zip(outs, weights))


@pytest.mark.parametrize("name", list(MODELS))
def test_batched_model_equals_its_unbatched_calls(name):
    fn, _, exact = MODELS[name]
    x, y, pb = _batch(exact=exact)
    tp = _tp(pb, requires_grad=True)
    outs = fn(t(x), t(y), tp)
    rng = np.random.default_rng(1)
    weights = [torch.tensor(rng.standard_normal(o.shape).astype(np.float32)) for o in outs]
    grads = torch.autograd.grad(_scalarize(outs, weights), list(tp.leaves().values()))
    for r in range(R):
        pr = _tp({f: None if v is None else v[r] for f, v in pb.items()}, requires_grad=True)
        one = fn(t(x), t(y), pr)
        for a, b in zip(outs, one):
            assert a.shape[1:] == b.shape
            _rel_close(a[r], b, 1e-6)
        g1 = torch.autograd.grad(_scalarize(one, [w[r] for w in weights]),
                                 list(pr.leaves().values()))
        for a, b in zip(grads, g1):
            _rel_close(a[r], b, GRAD_RTOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_batched_model_matches_jax_vmap(name):
    fn, jfn, exact = MODELS[name]
    x, y, pb = _batch(seed=2, exact=exact)
    rng = np.random.default_rng(3)
    tp = _tp(pb, requires_grad=True)
    outs = fn(t(x), t(y), tp)
    weights = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    def jloss(p):
        got = jax.vmap(lambda q: jfn(jnp.asarray(x), jnp.asarray(y), q))(p)
        return sum(jnp.sum(o * w) for o, w in zip(got, weights)), got

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(_jp(pb))
    for a, b in zip(outs, want):
        assert a.shape == b.shape
        _rel_close(a, b, 1e-4 if exact else 1e-5)
    grads = torch.autograd.grad(_scalarize(outs, [torch.tensor(w) for w in weights]),
                                list(tp.leaves().values()))
    for f, g in zip(tp.leaves(), grads):
        _rel_close(g, getattr(jg, f), 1e-4)


GRAD_RTOL = 1e-4  # batched against unbatched gradients (module docstring)

RULES = [("fitc", r) for r in ("crps", "nlml", "logs", "dss", "kc", "interval", "es")] + [
    ("exact", r) for r in ("crps", "nlml", "logs", "dss", "kc", "interval", "es")]


@pytest.mark.parametrize("model,rule", RULES)
def test_batched_objective_returns_each_restarts_loss(model, rule):
    """make_objective's loss of batched parameters is [R], each entry and its
    gradient the unbatched call's (es at the same fixed normals)."""
    x, y, pb = _batch(seed=4, exact=model == "exact")
    loss = make_objective(rule, model=model, num_sim=16)
    kw = {}
    if rule == "es":
        nb = x.shape[0] // FOLDS
        if model == "fitc":
            key = jax.random.PRNGKey(0)
            kw["eps"] = tuple(jax_fold_eps(k, FOLDS, nb, 5, 16) for k in jax.random.split(key))
        else:
            kw["eps"] = tuple(torch.tensor(np.random.default_rng(s).standard_normal(
                (FOLDS, nb, 16)).astype(np.float32)) for s in (5, 6))
    tp = _tp(pb, requires_grad=True)
    got = loss(tp, t(x), t(y), **kw)
    assert got.shape == (R,)
    grads = torch.autograd.grad(got.sum(), list(tp.leaves().values()))
    for r in range(R):
        pr = _tp({f: None if v is None else v[r] for f, v in pb.items()}, requires_grad=True)
        one = loss(pr, t(x), t(y), **kw)
        _rel_close(got[r], one, 1e-6)
        for a, b in zip(grads, torch.autograd.grad(one, list(pr.leaves().values()))):
            _rel_close(a[r], b, GRAD_RTOL)


def test_per_replicate_data_gives_each_replicate_its_own_loss():
    """x [R, n, d] and y [R, n]: restart r sees its own data."""
    xs, ys, pbs = zip(*(_batch(seed=10 + r, exact=True) for r in range(R)))
    pb = {f: None if pbs[0][f] is None else np.stack([p[f][r] for r, p in enumerate(pbs)])
          for f in FIELDS}
    loss = make_objective("dss", model="exact")
    got = loss(_tp(pb), t(np.stack(xs)), t(np.stack(ys)))
    for r in range(R):
        one = loss(_tp({f: None if v is None else v[r] for f, v in pb.items()}), t(xs[r]),
                   t(ys[r]))
        _rel_close(got[r], one, 1e-6)


def test_kfold_block_writes_are_batched_and_capturable():
    """_fold_blocks and _block_diag of a batch equal the per-matrix forms
    (torch.block_diag of each), with no Python loop over the batch."""
    rng = np.random.default_rng(7)
    M = torch.tensor(rng.standard_normal((R, 12, 12)).astype(np.float32))
    A = linalg._fold_blocks(M, 4)
    assert A.shape == (R, 4, 3, 3)
    for r in range(R):
        assert torch.equal(A[r], linalg._fold_blocks(M[r], 4))
        assert torch.equal(linalg._block_diag(A, 12)[r], torch.block_diag(*A[r]))


# ---- fit_gd_batch and restart_sweep --------------------------------------------


SWEEP_CASES = [("fitc", r) for r in ("crps", "nlml", "logs", "dss", "kc")] + [
    ("exact", r) for r in ("crps", "nlml", "dss")]


@pytest.mark.parametrize("model,rule", SWEEP_CASES)
def test_restart_sweep_matches_the_jax_sweep(model, rule):
    x, y, pb = _batch(seed=1, n=64, m=6, exact=model == "exact")
    sched = SCHEDULES[("kin40k_fitc" if model == "fitc" else "kin40k_full", rule)]
    loss = jax_make_objective(rule, model=model)
    want = jax.jit(lambda q: jax_restart_sweep(loss, q, jnp.asarray(x), jnp.asarray(y), 5,
                                               sched.lr, sched.lr_inducing))(_jp(pb))
    got = restart_sweep(make_objective(rule, model=model), _tp(pb), t(x), t(y), 5, sched.lr,
                        sched.lr_inducing)
    assert got.loss_history.shape == (R, 5)
    close(got.loss_history, want.loss_history, 1e-4)
    for f, v in got.params.leaves().items():
        _rel_close(v, getattr(want.params, f), 1e-4)
    assert got.ok.tolist() == np.asarray(want.ok).tolist() == [True] * R
    assert got.stall_iters.tolist() == np.asarray(want.stall_iters).tolist() == [0] * R


def _failing_restart(loss_fn, bad: int, from_call: int):
    """``loss_fn`` with restart ``bad``'s loss and gradient NaN from the call
    numbered ``from_call`` on, through a Cholesky of a matrix that is not
    SPD for that restart alone; the others' losses get + 0 * (a finite
    log-det), so their values and gradients are unchanged bit for bit."""
    calls = {"n": 0}

    def loss(params, x, y, generator=None, eps=None):
        value = loss_fn(params, x, y)
        calls["n"] += 1
        if calls["n"] - 1 >= from_call:
            sign = torch.ones(value.shape[0])
            sign[bad] = -1.0
            mat = torch.eye(2) * (sign * params.signal_sq)[:, None, None]
            value = value + 0.0 * linalg.half_logdet(linalg.chol_factor(mat))
        return value

    return loss


@pytest.mark.parametrize("model", ["fitc", "exact"])
def test_a_failed_restart_leaves_the_others_alone(model):
    x, y, pb = _batch(seed=5, n=48, exact=model == "exact")
    rule, steps, fail = ("crps", 8, 3)
    loss = make_objective(rule, model=model)
    healthy = fit_gd_batch(loss, _tp(pb), t(x), t(y), steps, 0.05, record_params=True)
    hurt = fit_gd_batch(_failing_restart(loss, 1, fail), _tp(pb), t(x), t(y), steps, 0.05,
                        record_params=True)
    hist = hurt.loss_history
    assert torch.isnan(hist[1, fail:]).all() and torch.isfinite(hist[1, :fail]).all()
    # Frozen from the failed step on, stall counted, the fit still ok.
    for f, v in hurt.param_history.leaves().items():
        assert all(torch.equal(v[1, i], v[1, fail]) for i in range(fail, steps)), f
        assert torch.equal(hurt.params.leaves()[f][1], v[1, fail]), f
    assert hurt.stall_iters.tolist() == [0, steps - fail, 0] and hurt.ok.tolist() == [True] * R
    for r in (0, 2):
        assert torch.equal(hist[r], healthy.loss_history[r])
        for f, v in hurt.params.leaves().items():
            assert torch.equal(v[r], healthy.params.leaves()[f][r])
        solo = fit_gd(loss, select_params(_tp(pb), r), t(x), t(y), steps, 0.05)
        close(hist[r], solo.loss_history, 1e-5)
        for f, v in solo.params.leaves().items():
            _rel_close(hurt.params.leaves()[f][r], v, 1e-5)


def test_fit_gd_batch_histories_take_the_vmap_layout():
    x, y, pb = _batch(seed=6)
    loss = make_objective("nlml", model="fitc")
    res = fit_gd_batch(loss, _tp(pb), t(x), t(y), 4, 1e-3, 1e-2, record_params=True)
    assert res.loss_history.shape == (R, 4) and res.ok.shape == (R,)
    assert res.stall_iters.shape == (R,) and res.stall_iters.dtype == torch.int32
    ph = res.param_history
    assert ph.inducing.shape == (R, 4, 5, 3) and ph.log_signal_sq.shape == (R, 4)
    close(ph.log_length[:, 0], pb["log_length"], 0)  # the pre-update point
    for i in range(4):
        at = ph.replace(**{f: v[:, i] for f, v in ph.leaves().items()})
        close(res.loss_history[:, i], loss(at, t(x), t(y)), 1e-6)


def test_fit_gd_and_fit_gd_batch_refuse_the_wrong_parameters():
    x, y, pb = _batch(seed=7)
    loss = make_objective("crps", model="fitc")
    with pytest.raises(ValueError, match="fit_gd_batch"):
        fit_gd(loss, _tp(pb), t(x), t(y), 2, 0.1)
    with pytest.raises(ValueError, match="leading"):
        fit_gd_batch(loss, select_params(_tp(pb), 0), t(x), t(y), 2, 0.1)
    with pytest.raises(ValueError, match="one loss per restart"):
        fit_gd_batch(lambda p, x, y, g=None: loss(p, x, y).sum(), _tp(pb), t(x), t(y), 2, 0.1)


def test_restart_sweep_runs_the_fused_sizes_one_after_another(monkeypatch):
    """At the exact GP's fused sizes the restarts are solo fit_gd fits, in
    order, stacked in the vmap layout."""
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 32)
    x, y, pb = _batch(seed=8, n=32, exact=True)
    loss = make_objective("crps", model="exact", block=16)
    got = restart_sweep(loss, _tp(pb), t(x), t(y), 3, 0.1)
    assert got.loss_history.shape == (R, 3) and got.param_history is None
    for r in range(R):
        solo = fit_gd(loss, select_params(_tp(pb), r), t(x), t(y), 3, 0.1)
        assert torch.equal(got.loss_history[r], solo.loss_history)
        assert int(got.stall_iters[r]) == int(solo.stall_iters)


def test_default_sweep_generator_is_seeded_zero_on_the_data_device():
    a, b = default_sweep_generator(), default_sweep_generator("cpu")
    assert a.device.type == "cpu" and torch.equal(torch.rand(3, generator=a),
                                                  torch.rand(3, generator=b))
    assert torch.equal(torch.rand(3, generator=default_sweep_generator()),
                       torch.rand(3, generator=torch.Generator().manual_seed(0)))


def test_batched_es_draws_every_restart_from_one_generator():
    """es in a batch draws [R, ...] normals a step from the one generator:
    two sweeps from the same seed agree, and the restarts see other draws."""
    x, y, pb = _batch(seed=9, exact=True)
    loss = make_objective("es", model="exact", num_sim=8)
    runs = [restart_sweep(loss, _tp(pb), t(x), t(y), 3, 0.01,
                          generator=torch.Generator().manual_seed(4)) for _ in range(2)]
    assert torch.equal(runs[0].loss_history, runs[1].loss_history)
    same = _tp({f: None if v is None else np.stack([v[0]] * R) for f, v in pb.items()})
    one = loss(same, t(x), t(y), torch.Generator().manual_seed(4))
    assert torch.isfinite(one).all() and len(set(one.tolist())) == R


def test_params_stack_select_and_batched_init():
    ps = [init_rand_params(torch.Generator().manual_seed(s), 4, num_inducing=3)
          for s in range(R)]
    pb = stack_params(ps)
    assert batch_size(pb) == R and batch_size(ps[0]) is None
    for r, p in enumerate(ps):
        for f, v in select_params(pb, r).leaves().items():
            assert torch.equal(v, p.leaves()[f])
    b = init_rand_params(torch.Generator().manual_seed(1), 8, num_inducing=20, batch=16)
    assert b.log_length.shape == (16, 8) and b.log_signal_sq.shape == (16,)
    assert b.inducing.shape == (16, 20, 8) and ((b.inducing >= 0) & (b.inducing < 1)).all()
    again = init_rand_params(torch.Generator().manual_seed(1), 8, num_inducing=20, batch=16)
    assert all(torch.equal(v, again.leaves()[f]) for f, v in b.leaves().items())
    u = init_rand_params(torch.Generator().manual_seed(1), 8, unit_scalars=True, batch=2)
    assert u.log_noise_sq.tolist() == [1.0, 1.0] and u.inducing is None


# ---- the drivers -------------------------------------------------------------


JAX_KEYS = {"mse", "smse", "logs", "crps", "msll", "coverage95", "best_restart",
            "best_final_loss", "worst_final_loss", "num_restarts", "num_failed"}


def _cut(iters):
    return {k: dataclasses.replace(s, iters=iters) for k, s in SCHEDULES.items()}


@pytest.mark.parametrize("argv,tags", [
    ([], ["crps_m20", "nlml_m20"]),
    (["--model", "exact", "--rules", "crps", "dss"], ["crps", "dss"]),
    (["--num-inducing", "3", "5", "--rules", "kc"], ["kc_m3", "kc_m5"])])
def test_multi_restart_runs_on_the_cpu_with_the_jax_keys(tmp_path, monkeypatch, argv, tags):
    monkeypatch.setattr(multi_restart, "SCHEDULES", _cut(3))
    out = tmp_path / "r.json"
    res = multi_restart.main(["--device", "cpu", "--restarts", "3", "--out", str(out)] + argv)
    assert list(res) == tags and out.exists()
    for tag, rec in res.items():
        assert set(rec) == JAX_KEYS, tag
        assert rec["num_restarts"] == 3 and rec["num_failed"] == 0
        assert rec["best_final_loss"] <= rec["worst_final_loss"]
        assert all(np.isfinite(rec[f]) for f in ("crps", "logs", "smse"))


def test_multi_restart_ranks_failed_restarts_last(monkeypatch):
    """A restart whose final loss is NaN is never the best, and is counted."""
    monkeypatch.setattr(multi_restart, "SCHEDULES", _cut(2))
    real = multi_restart.restart_sweep

    def sweep(*a, **kw):
        res = real(*a, **kw)
        res.loss_history[0, -1] = float("nan")
        return res

    monkeypatch.setattr(multi_restart, "restart_sweep", sweep)
    res = multi_restart.main(["--device", "cpu", "--restarts", "3", "--rules", "nlml"])
    assert res["nlml_m20"]["num_failed"] == 1 and res["nlml_m20"]["best_restart"] != 0


def test_multi_restart_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        multi_restart.main(["--restarts", "2"])


def test_fit_and_eval_batch_equals_fit_and_eval_per_replicate():
    xs, ys, pbs = zip(*(_batch(seed=20 + r, exact=True) for r in range(R)))
    pb = {f: None if pbs[0][f] is None else np.stack([p[f][r] for r, p in enumerate(pbs)])
          for f in FIELDS}
    sched = Schedule("crps", 4, 0.1)
    X, Y = t(np.stack(xs)), t(np.stack(ys))
    ms, res = fit_and_eval_batch("crps", "exact", sched, _tp(pb), X, Y, X[:, :8], Y[:, :8])
    assert len(ms) == R and res.loss_history.shape == (R, 4)
    for r in range(R):
        m, one = fit_and_eval("crps", "exact", sched, select_params(_tp(pb), r), X[r], Y[r],
                              X[r, :8], Y[r, :8])
        close(res.loss_history[r], one.loss_history, 1e-5)
        for a, b in zip(ms[r], m):
            close(a, b, 1e-4, 1e-6)


def test_run_sweep_batches_the_replicates_as_the_loop_does(monkeypatch):
    """run_sweep's batched sweep and its replicate loop (forced by the fused
    threshold) agree on every per-rule mean."""
    def make_data(j):
        x, y, _ = problem(seed=70 + j, n=32, m=1, d=2)
        xs, ys, _ = problem(seed=80 + j, n=16, m=1, d=2)
        return x, y, xs, ys

    sched = {r: Schedule(r, 4, SCHEDULES[("kin40k_full", r)].lr) for r in ("crps", "dss")}
    calls = []
    real = common.fit_and_eval_batch
    monkeypatch.setattr(common, "fit_and_eval_batch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def sweep():
        return common.run_sweep(["crps", "dss"], "exact", sched, make_data,
                                lambda g, d: init_rand_params(g, d), replicates=3, d=2,
                                verbose=False, device="cpu")

    batched = sweep()
    assert len(calls) == 2
    monkeypatch.setattr(objectives, "_FUSED_LOO_MIN_N", 32)  # the loop, through fit_gd
    looped = sweep()
    assert len(calls) == 2
    for rule in ("crps", "dss"):
        for f in ("mse", "logs", "crps", "msll"):
            close(batched[rule][f], looped[rule][f], 1e-4)
        assert batched[rule]["num_failed"] == looped[rule]["num_failed"] == 0
