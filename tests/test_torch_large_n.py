"""The port's large-n exact GP against gpscore's: the in-place K_hat^-1
pipeline, the three fused cores (values and gradients), the four fused
objectives, the chunked large-n predictive, auto_block, and the large_n
and bench_ceiling experiments (the fold rules' cores are in
tests/test_torch_fold_stream.py).

The JAX side runs as its own tests run it on the CPU, jitted: its fused
cores with ``inplace=True`` (the JAX Gram is the jnp form, no Pallas
kernel). It pads n up to a multiple of the block and masks the pad; the port
runs a ragged last panel, and the two are compared on the real [:n, :n]
block.

Tolerances: the inverse rtol 2e-4, atol 1e-5 (fp32, panel GEMMs in another
order); half log-det rtol 1e-5; values and gradients of the cores and the
objectives rtol 2e-4, atol 1e-5, as the JAX package's own fused-core tests
(`tests/test_potri_inplace.py`); the predictive rtol 1e-4, atol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpscore.fit.objectives as jobjectives
import gpscore.ops.fold_stream as jfold
import gpscore.ops.loo_fused as jloo
from gpscore.fit import make_objective as jax_make_objective
from gpscore.models.exact import exact_predictive_diag_large as jax_predictive_large
from gpscore.ops.potri_inplace import (ard_gram_chol_inplace as jax_chol_inplace,
                                       ard_gram_inverse_inplace as jax_inverse_inplace,
                                       pad_rows)
from gpscore_torch.experiments import bench_ceiling, large_n
from gpscore_torch.fit import SCHEDULES, fit_gd, make_objective
from gpscore_torch.fit import objectives as tobjectives
from gpscore_torch.models import exact as texact
from gpscore_torch.ops import fold_stream as tfold
from gpscore_torch.ops import gram_cuda as tgram
from gpscore_torch.ops import loo_fused as tloo
from gpscore_torch.ops import potri_inplace as tpotri
from torch_parity import close, jax_params, t, torch_params

RTOL, ATOL = 2e-4, 1e-5
SCHEDULE_LR_DSS = SCHEDULES[("kin40k_full", "dss")].lr
SIZES = [(64, 16), (52, 16)]  # an exact multiple of the block, and a ragged last panel


def _problem(seed, n, d=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    p = {"log_signal_sq": np.float32(0.3),
         "log_length": (0.3 * rng.standard_normal(d)).astype(np.float32),
         "log_noise_sq": np.float32(-1.2), "inducing": None}
    return x, y, p


def _jax_args(p):
    return [jnp.asarray(p[f]) for f in ("log_signal_sq", "log_length", "log_noise_sq")]


def _torch_args(p, requires_grad=False):
    return [torch.tensor(p[f], requires_grad=requires_grad)
            for f in ("log_signal_sq", "log_length", "log_noise_sq")]


def _padded(x, block):
    return pad_rows(jnp.asarray(x), -(-x.shape[0] // block) * block)


# ---- the in-place pipeline ----------------------------------------------------


@pytest.mark.parametrize("n,block", SIZES)
def test_inplace_inverse_and_half_logdet_match_jax(n, block):
    x, _, p = _problem(1, n)
    inverse = jax.jit(jax_inverse_inplace, static_argnums=(4, 5),
                      static_argnames="return_half_logdet")
    want, want_hld = inverse(*_jax_args(p), _padded(x, block), n, block,
                             return_half_logdet=True)
    got, hld = tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), block,
                                               return_half_logdet=True)
    assert got.shape == (n, n)
    close(got, np.asarray(want)[:n, :n], RTOL, ATOL)
    close(hld, float(want_hld), 1e-5)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("n,block", SIZES)
def test_inplace_cholesky_matches_jax(n, block):
    x, _, p = _problem(2, n)
    chol = jax.jit(jax_chol_inplace, static_argnums=(4, 5))
    want, want_hld = chol(*_jax_args(p), _padded(x, block), n, block)
    got, hld = tpotri.ard_gram_chol_inplace(*_torch_args(p), t(x), block)
    close(got, np.asarray(want)[:n, :n], RTOL, ATOL)
    assert torch.equal(got, got.tril())
    close(hld, float(want_hld), 1e-5)


def test_failed_leaf_factor_is_nan_and_does_not_raise():
    """A matrix that is not SPD: the pipeline returns NaN, as chol_factor
    does, and raises nothing."""
    W = -torch.eye(10)
    hld = tpotri.chol_inplace(W, 4)
    tpotri.tri_inv_inplace(W, 4)
    tpotri.lauum_inplace(W, 4)
    assert torch.isnan(hld) and torch.isnan(W).all()


def test_only_fp32_storage_is_ported():
    """The storage dtypes the pipeline takes: fp32 (None the same, bit for
    bit), bfloat16 and float16 (tests/test_torch_precision.py holds them
    against JAX); any other raises. The predictive takes ``refine`` and
    ``storage`` too."""
    x, y, p = _problem(3, 16)
    fp32 = tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), 8)
    assert torch.equal(fp32, tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), 8,
                                                             storage=torch.float32))
    for st in (torch.bfloat16, torch.float16):
        got = tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), 8, storage=st)
        assert got.dtype == st and torch.isfinite(got.float()).all()
    with pytest.raises(TypeError, match="storage"):
        tpotri.ard_gram_inverse_inplace(*_torch_args(p), t(x), 8, storage=torch.float64)
    pred = texact.exact_predictive_diag_large(t(x), t(y), t(x), torch_params(p), block=8,
                                              storage=torch.float16, refine=2)
    assert torch.isfinite(pred.mean).all() and torch.isfinite(pred.cov).all()


# ---- the fused cores ----------------------------------------------------------


def _jax_core(core, x, block):
    xj = jnp.asarray(x)
    if core == "loo":
        def f(s, ell, nu, y):
            a, dg = jloo.ard_loo_solve_diag(s, ell, nu, xj, y, block, True)
            return jnp.sum(jnp.sin(a) * dg) + jnp.sum(jnp.sqrt(dg))
    elif core == "kfold":
        def f(s, ell, nu, y):
            a, A = jloo.ard_kfold_solve_blocks(s, ell, nu, xj, y, 4, block, True)
            return jnp.sum(jnp.sin(a)) + jnp.sum(jnp.cos(A))
    else:
        def f(s, ell, nu, y):
            return jloo.ard_nlml(s, ell, nu, xj, y, block, True)
    return f


def _torch_core(core, x, block):
    xt = t(x)
    if core == "loo":
        def f(s, ell, nu, y):
            a, dg = tloo.ard_loo_solve_diag(s, ell, nu, xt, y, block)
            return torch.sum(torch.sin(a) * dg) + torch.sum(torch.sqrt(dg))
    elif core == "kfold":
        def f(s, ell, nu, y):
            a, A = tloo.ard_kfold_solve_blocks(s, ell, nu, xt, y, 4, block)
            return torch.sum(torch.sin(a)) + torch.sum(torch.cos(A))
    else:
        def f(s, ell, nu, y):
            return tloo.ard_nlml(s, ell, nu, xt, y, block)
    return f


@pytest.mark.parametrize("n,block", SIZES)
@pytest.mark.parametrize("core", ["loo", "kfold", "nlml"])
def test_fused_core_values_and_gradients_match_jax(core, n, block):
    """ArdLooSolveDiag, ArdKfoldSolveBlocks and ArdNlml through a scalar
    function of their outputs: the value and the gradients to the three
    log-parameters and y."""
    x, y, p = _problem(4, n)
    jargs = _jax_args(p) + [jnp.asarray(y)]
    want, want_g = jax.jit(jax.value_and_grad(_jax_core(core, x, block),
                                              argnums=(0, 1, 2, 3)))(*jargs)
    targs = _torch_args(p, requires_grad=True) + [torch.tensor(y, requires_grad=True)]
    got = _torch_core(core, x, block)(*targs)
    for g, w in zip(torch.autograd.grad(got, targs), want_g):
        close(g, w, RTOL, ATOL)
    close(got, float(want), 1e-5)
    if core == "nlml":  # the value alone: Cholesky and one solve, no inverse
        with torch.no_grad():
            close(_torch_core(core, x, block)(*targs), float(want), 1e-5)



@pytest.mark.parametrize("core", ["loo", "fold"])
def test_fused_cores_at_a_wide_input_match_jax(core):
    """At d = 70 (the Gram kernels' d-chunked builds on a card), n = 96,
    block 40 (a ragged last panel): the fused LOO core and the fold-streamed
    fold statistics (fold_k = 4), value and gradients to the three
    log-parameters and y, through a scalar function of their outputs. The log
    lengths are raised by log(d / 8) / 2, so K is no identity; gradients at
    RTOL with ATOL + RTOL of the leaf's largest entry (a length gradient's
    entry sums 96^2 terms of both signs)."""
    n, d, block = 96, 70, 40
    x, y, p = _problem(6, n, d)
    p["log_length"] = (p["log_length"] + 0.5 * np.log(d / 8.0)).astype(np.float32)
    xs = x * np.exp(-p["log_length"])
    K = np.exp(-0.5 * ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1))
    assert K[np.triu_indices(n, 1)].max() > 10 * K[np.triu_indices(n, 1)].min()
    if core == "loo":
        jf, tf = _jax_core("loo", x, block), _torch_core("loo", x, block)
    else:
        wts = [np.random.default_rng(7).standard_normal(s).astype(np.float32)
               for s in ((4, n // 4), (4,), (4, n // 4), (n,))]
        xj, xt = jnp.asarray(x), t(x)

        def jf(s_, ell, nu, yy):
            outs = jfold.ard_fold_stats_stream(s_, ell, nu, xj, yy, 4, True)
            return sum(jnp.sum(jnp.asarray(w) * o) for w, o in zip(wts, outs))

        def tf(s_, ell, nu, yy):
            outs = tfold.ard_fold_stats_stream(s_, ell, nu, xt, yy, 4, True, block)
            return sum(torch.sum(t(w) * o) for w, o in zip(wts, outs))
    jargs = _jax_args(p) + [jnp.asarray(y)]
    want, want_g = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(*jargs)
    targs = _torch_args(p, requires_grad=True) + [torch.tensor(y, requires_grad=True)]
    got = tf(*targs)
    close(got, float(want), RTOL, ATOL)
    for g, w in zip(torch.autograd.grad(got, targs), want_g):
        close(g, w, RTOL, ATOL + RTOL * float(np.abs(np.asarray(w)).max()))

@pytest.mark.parametrize("core", ["loo", "kfold", "nlml"])
def test_log_signal_gradient_closed_form_equals_the_streamed_sum(core):
    """The log-signal gradient (the sum of the Gram backward's rowsums) against
    its O(n) closed form and the JAX core's. K_hat -> e^t K_hat moves log-signal
    and log-noise together and scales a, diag K^-1 and the fold blocks by e^-t,
    so log_signal_bar + log_noise_bar = tr(K_hat_bar K_hat) = -sum out_bar o out
    over a core's outputs; (n - y^T a) / 2 for the NLML. rtol 1e-4."""
    n, block = 52, 16
    x, y, p = _problem(9, n)
    want = jax.jit(jax.grad(_jax_core(core, x, block)))(*_jax_args(p), jnp.asarray(y))
    s, ell, nu = _torch_args(p, requires_grad=True)
    if core == "nlml":
        value = tloo.ard_nlml(s, ell, nu, t(x), t(y), block)
        a, _ = tloo.ard_loo_solve_diag(s.detach(), ell.detach(), nu.detach(), t(x), t(y), block)
        s_bar, n_bar = torch.autograd.grad(value, (s, nu))
        trace = 0.5 * (n - torch.dot(t(y), a))
    else:
        outs = (tloo.ard_loo_solve_diag(s, ell, nu, t(x), t(y), block) if core == "loo" else
                tloo.ard_kfold_solve_blocks(s, ell, nu, t(x), t(y), 4, block))
        value = (torch.sum(torch.sin(outs[0]) * outs[1]) + torch.sum(torch.sqrt(outs[1]))
                 if core == "loo" else torch.sum(torch.sin(outs[0])) + torch.sum(torch.cos(outs[1])))
        s_bar, n_bar, *out_bars = torch.autograd.grad(value, (s, nu, *outs))
        trace = -sum(torch.sum(o_bar * o.detach()) for o_bar, o in zip(out_bars, outs))
    close(s_bar, want, RTOL, ATOL)
    close(s_bar, (trace - n_bar).numpy(), 1e-4)


# ---- the fused objectives -----------------------------------------------------

RULES = ["crps", "logs", "interval", "nlml"]


@pytest.mark.parametrize("kernel", ["ard", "rbf"])
@pytest.mark.parametrize("rule", RULES)
def test_fused_objectives_match_jax(monkeypatch, rule, kernel):
    """make_objective with the fused threshold at 1 on both sides (and the
    JAX cores' in-place threshold); both at block 16 over a ragged n."""
    n, d, block = 52, 3, 16
    x, y, p = _problem(5, n, d)
    if kernel == "rbf":
        p["log_length"] = np.float32(0.4)
    monkeypatch.setattr(jobjectives, "_FUSED_LOO_MIN_N", 1)
    monkeypatch.setattr(jloo, "_INPLACE_MIN_N", 1)
    monkeypatch.setattr(jloo, "auto_block", lambda n, storage_bytes=None: block)
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    jloss = jax_make_objective(rule, model="exact", kernel=kernel)
    want, want_g = jax.jit(jax.value_and_grad(jloss))(jax_params(p), jnp.asarray(x),
                                                      jnp.asarray(y), None)
    tp = torch_params(p, requires_grad=True)
    got = make_objective(rule, model="exact", kernel=kernel, block=block)(tp, t(x), t(y))
    leaves = tp.leaves()
    grads = torch.autograd.grad(got, list(leaves.values()))
    close(got, float(want), 1e-5)
    for f, g in zip(leaves, grads):
        close(g, getattr(want_g, f), RTOL, ATOL)


def test_fit_gd_through_the_fused_crps_matches_the_dense_one(monkeypatch):
    """Five crps GD steps (lr 1): the fused core's losses and parameters
    against the dense path's, rtol 1e-4."""
    x, y, p = _problem(6, 48)
    loss = make_objective("crps", model="exact", block=16)
    dense = fit_gd(loss, torch_params(p), t(x), t(y), 5, 1.0)
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    fused = fit_gd(loss, torch_params(p), t(x), t(y), 5, 1.0)
    close(fused.loss_history, dense.loss_history.numpy(), 1e-4)
    for f, v in dense.params.leaves().items():
        close(fused.params.leaves()[f], v.numpy(), 1e-4, 1e-6)


# ---- evaluation, block size, drivers -------------------------------------------


def test_predictive_diag_large_matches_jax():
    n, nt = 52, 23
    x, y, p = _problem(7, n)
    xt = np.random.default_rng(8).standard_normal((nt, 3)).astype(np.float32)
    predictive = jax.jit(jax_predictive_large, static_argnames=("block", "chunk"))
    want = predictive(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), jax_params(p),
                      block=16, chunk=16)
    got = texact.exact_predictive_diag_large(t(x), t(y), t(xt), torch_params(p), block=16,
                                             chunk=16)
    close(got.mean, want.mean, 1e-4, 1e-5)
    close(got.cov, want.cov, 1e-4, 1e-5)


def test_auto_block_matches_jax_at_a_fixed_budget():
    """At the JAX package's budget (its _HBM_BYTES), fp32 storage; the CPU's
    own budget is unbounded, so the widest divisor wins there."""
    for n in (512, 1536, 2048, 8192, 30000, 30720, 57344, 61440, 62464, 65536):
        assert tloo.auto_block(n, budget_bytes=jloo._HBM_BYTES) == jloo.auto_block(n, 4), n
    assert tloo.auto_block(62464, device="cpu") == 1024
    assert tloo.auto_block(30000) == 2048


def test_large_n_driver_fits_saves_and_loads_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The large_n experiment at n = 128 with the fused threshold lowered, so the fits
    run the fused cores: finite losses and metrics, and the saved parameters
    load back to the same evaluation."""
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
    prefix = str(tmp_path / "p")
    common = ["--n", "128", "--n-test", "40", "--block", "48", "--eval-chunk", "16",
              "--device", "cpu"]
    res = large_n.main(common + ["--iters", "2", "--rules", "crps", "nlml",
                                 "--save-params", prefix, "--out", str(tmp_path / "r.json")])
    for rule in ("crps", "nlml"):
        rec = res[rule]
        assert rec["iters"] == 2 and rec["stall_iters"] == 0
        assert all(math.isfinite(rec[k]) for k in ("loss_first", "loss_last", "fit_wall_s",
                                                   "s_per_iter_steady", "crps", "mse"))
    assert res["nlml"]["lr"] == pytest.approx(0.0005 * 500 / 128)
    loaded = large_n.main(common + ["--rules", "crps", "nlml", "--load-params", prefix])
    for rule in ("crps", "nlml"):
        assert loaded[rule]["crps"] == pytest.approx(res[rule]["crps"], rel=1e-6)
    assert "[nlml] {" in capsys.readouterr().out


def test_large_n_experiment_fits_the_fold_rules_on_the_cpu(monkeypatch, capsys):
    """dss, kc and es through the fold-streamed cores (threshold lowered);
    es draws from the experiment's seeded generator, so two runs agree."""
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
    argv = ["--n", "128", "--n-test", "40", "--block", "48", "--eval-chunk", "16",
            "--device", "cpu", "--iters", "2", "--rules", "dss", "kc", "es"]
    res, again = large_n.main(argv), large_n.main(argv + ["--skip-eval"])
    for rule in ("dss", "kc", "es"):
        rec = res[rule]
        assert rec["iters"] == 2 and rec["stall_iters"] == 0
        assert all(math.isfinite(rec[k]) for k in ("loss_first", "loss_last", "crps", "mse"))
        assert again[rule]["loss_last"] == rec["loss_last"]
    assert res["dss"]["lr"] == pytest.approx(SCHEDULE_LR_DSS * 500 / 128)
    assert "[es] {" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        large_n.main(["--n", "126", "--rules", "dss", "--device", "cpu"])


@pytest.mark.parametrize("rule,flop", [("crps", 3.0), ("dss", 3.5), ("es", 3.5)])
def test_bench_ceiling_runs_on_the_cpu(monkeypatch, rule, flop):
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
    rec = bench_ceiling.main(["--n", "96", "--block", "32", "--repeats", "1", "--device", "cpu",
                              "--rule", rule])
    assert math.isfinite(rec["loss"]) and rec["step_s"] > 0
    assert rec["flop"] == flop * 96 ** 3 and rec["peak_n2"] is None


def test_bench_ceiling_crossover_times_both_paths_and_restores_the_threshold():
    before = tobjectives._FUSED_LOO_MIN_N
    recs = bench_ceiling.main(["--crossover", "64", "96", "--repeats", "1", "--device", "cpu"])
    assert [(r["n"], r["rule"], r["path"]) for r in recs] == [
        (n, rule, path) for n in (64, 96) for rule in ("crps", "dss")
        for path in ("dense", "fused")]
    assert all(r["step_s"] > 0 and r["peak_n2"] is None for r in recs)
    assert tobjectives._FUSED_LOO_MIN_N == before


# ---- the precision modes through the objectives and the large_n experiment -------


@pytest.mark.parametrize("mode", ["high", "fast", "bf16", "f16"])
@pytest.mark.parametrize("rule", ["crps", "nlml"])
def test_fused_objectives_in_each_mode_match_jax(monkeypatch, rule, mode):
    """make_objective under each reduced mode on both sides (fused threshold
    at 1, in place, block 16, a ragged n): "high" at the fp32 tolerances,
    the others at value rtol 2e-2 and gradient cosine > 0.999 per leaf
    (`tests/test_potri_inplace.py:141-173`)."""
    from gpscore.utils.precision import matmul_mode as jax_matmul_mode
    from gpscore_torch.utils import precision
    from gpscore_torch.utils.precision import matmul_mode

    monkeypatch.setattr(precision, "_SPLIT_MIN_K", 0)  # "high" splits at every size
    n, block = 52, 16
    x, y, p = _problem(10, n)
    monkeypatch.setattr(jobjectives, "_FUSED_LOO_MIN_N", 1)
    monkeypatch.setattr(jloo, "_INPLACE_MIN_N", 1)
    monkeypatch.setattr(jloo, "auto_block", lambda n, storage_bytes=None: block)
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    with jax_matmul_mode(mode):  # read when jax.jit traces
        want, want_g = jax.jit(jax.value_and_grad(jax_make_objective(rule, model="exact")))(
            jax_params(p), jnp.asarray(x), jnp.asarray(y), None)
    tp = torch_params(p, requires_grad=True)
    leaves = tp.leaves()
    with matmul_mode(mode):
        got = make_objective(rule, model="exact", block=block)(tp, t(x), t(y))
        grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    for f, g in grads.items():
        w = np.asarray(getattr(want_g, f), np.float64).ravel()
        if mode == "high":
            close(g, w, RTOL, ATOL)
        else:
            g = g.double().numpy().ravel()
            assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999, f
    close(got, float(want), 1e-5 if mode == "high" else 2e-2)


def test_large_n_driver_runs_each_precision_flag_on_the_cpu(monkeypatch):
    """--matmul bf16 through fit_gd_recovering (the fused cores, threshold
    lowered), --polish-iters, and an f16-stored refined evaluation: the
    recovery trail and the evaluation's storage land in the record; the
    refined f16 evaluation agrees with the fp32 one."""
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
    common = ["--n", "128", "--n-test", "40", "--block", "48", "--eval-chunk", "16",
              "--device", "cpu", "--iters", "2", "--rules", "crps", "dss"]
    res = large_n.main(common + ["--matmul", "bf16", "--polish-iters", "1",
                                 "--eval-storage", "f16", "--eval-refine", "8"])
    ref = large_n.main(common + ["--matmul", "high", "--eval-storage", "f32"])
    for rule in ("crps", "dss"):
        rec = res[rule]
        assert rec["matmul"] == "bf16" and rec["recovery"] == [] and rec["stall_iters"] == 0
        assert rec["eval_storage"] == "f16" and rec["eval_refine"] == 8
        assert ref[rule]["eval_storage"] == "f32" and ref[rule]["eval_refine"] == 0
        assert all(math.isfinite(rec[k]) for k in ("loss_first", "loss_last", "crps", "mse"))
        assert rec["loss_first"] == pytest.approx(ref[rule]["loss_first"], rel=2e-2)
    with pytest.raises(SystemExit):
        large_n.main(common + ["--matmul", "tf32"])


def test_bench_ceiling_takes_the_precision_modes_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 64)
    recs = {mode: bench_ceiling.main(["--n", "96", "--block", "32", "--repeats", "1",
                                      "--device", "cpu", "--rule", "crps", "--matmul", mode])
            for mode in ("highest", "high", "f16")}
    for mode, rec in recs.items():
        assert rec["matmul"] == mode and rec["flop"] == 3.0 * 96 ** 3
    assert recs["high"]["loss"] == pytest.approx(recs["highest"]["loss"], rel=1e-5)
    assert recs["f16"]["loss"] == pytest.approx(recs["highest"]["loss"], rel=2e-2)
    with pytest.raises(SystemExit):
        bench_ceiling.main(["--ceiling", "64", "32", "--device", "cpu"])


# ---- the streamed backward's lower block-triangle -----------------------------

STREAM_CORES = ["loo", "kfold", "nlml", "dss", "kc", "es"]
FOLD_RULES = ("dss", "kc", "es")


def _full_row_pass(rows, w, a, xs, sig, block):
    """The streamed pass as the cores ran it on full rows: each row block's
    rows of K_hat_bar over all n columns, minus w[r0:r1] a^T, through the
    Gram backward; (log_signal_bar, log_length_bar, trace)."""
    n = xs.shape[0]
    sig_bar, len_bar, trace = 0.0, xs.new_zeros(xs.shape[1]), 0.0
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        g = rows(r0, r1)
        if w is not None:
            g = g - torch.outer(w[r0:r1], a)
        trace = trace + torch.sum(torch.diagonal(g[:, r0:r1]))
        d_xs, d_xps, row = tgram.gram_bwd(xs[r0:r1], xs, sig, g.contiguous())
        sig_bar = sig_bar + torch.sum(row)
        len_bar = len_bar - torch.sum(d_xs * xs[r0:r1], dim=0) - torch.sum(d_xps * xs, dim=0)
    return sig_bar, len_bar, trace


def _full_row_fold_cot(rule, Kinv, a, f, nb, cot, eps, num_sim):
    """(-A_bar_f, u) of fold f as the fold cores formed it for full rows:
    u e^T and the es core's T left unsymmetrized."""
    s = slice(f * nb, (f + 1) * nb)
    La = torch.linalg.cholesky(Kinv[s, s])
    e_f = torch.cholesky_solve(a[s, None], La)[:, 0]
    if rule != "es":
        e_bar, hld_bar, d_bar, _ = cot
        Ainv = torch.cholesky_inverse(La)
        u = Ainv @ e_bar[f]
        S = -0.5 * hld_bar[f] * Ainv
        if rule == "kc":
            S = S + Ainv @ torch.diag(d_bar[f]) @ Ainv
        return S + torch.outer(u, e_f), u
    with torch.enable_grad():
        zT = torch.linalg.solve_triangular(La.mT, eps[f], upper=True).requires_grad_()
        e_ = e_f.detach().requires_grad_()
        score = tfold._es_from_cols(zT, e_, num_sim, 1.0)
        zT_bar, e_bar = torch.autograd.grad(score, (zT, e_), cot[0][f])
    u = torch.cholesky_solve(e_bar[:, None], La)[:, 0]
    H = (eps[f] @ torch.linalg.solve_triangular(La, zT_bar, upper=False).T).tril()
    H.diagonal().mul_(0.5)
    T = torch.linalg.solve_triangular(La.mT, H, upper=True)
    T = torch.linalg.solve_triangular(La, T, upper=False, left=False)
    return T + torch.outer(u, e_f), u


def _full_row_grads(core, args, x, y, cot, block, fold_k, eps, num_sim):
    """The oracle: (log_signal_bar, log_length_bar, log_noise_bar, y_bar) of a
    core by the full-row arithmetic, from the forward's own K_hat^-1."""
    s, ell, nu = (v.detach() for v in args)
    Kinv = tpotri.ard_gram_inverse_inplace(s, ell, nu, x, block)
    a = Kinv @ y
    xs, sig = tgram.scale_inputs(x, ell), torch.exp(s)
    n, nb = x.shape[0], x.shape[0] // fold_k
    if core == "nlml":
        half = 0.5 * cot[0]
        sums = _full_row_pass(lambda r0, r1: half * Kinv[r0:r1], half * a, a, xs, sig, block)
        y_bar = cot[0] * a
    elif core in ("loo", "kfold"):
        y_bar = Kinv @ cot[0]

        def rows(r0, r1):
            if core == "loo":
                return -(Kinv[r0:r1] * cot[1][None, :]) @ Kinv
            M = torch.einsum("sfi,fij->sfj", Kinv[r0:r1].reshape(r1 - r0, fold_k, nb), cot[1])
            return -M.reshape(r1 - r0, n) @ Kinv

        sums = _full_row_pass(rows, y_bar, a, xs, sig, block)
    else:
        a_bar = cot[3].clone() if core != "es" else torch.zeros_like(a)
        sums, y_bar = (0.0, 0.0, 0.0), None
        for f in range(fold_k):
            fs = slice(f * nb, (f + 1) * nb)
            S, u = _full_row_fold_cot(core, Kinv, a, f, nb, cot, eps, num_sim)
            a_bar[fs] += u
            if f == fold_k - 1:
                y_bar = Kinv @ a_bar
            part = _full_row_pass(lambda r0, r1: Kinv[r0:r1, fs] @ S @ Kinv[fs],
                                  y_bar, a, xs, sig, block)
            sums = tuple(p + q for p, q in zip(sums, part))
    sig_bar, len_bar, trace = sums
    return sig_bar, len_bar.reshape(ell.shape), torch.exp(nu) * trace, y_bar


def _stream_core(core, args, x, y, block, fold_k, eps, num_sim):
    """The single-device core's outputs and a float64 cotangent for each."""
    g = torch.Generator().manual_seed(21)
    n, nb = x.shape[0], x.shape[0] // fold_k

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    if core == "loo":
        return tloo.ard_loo_solve_diag(*args, x, y, block), (randn(n), randn(n))
    if core == "kfold":
        return (tloo.ard_kfold_solve_blocks(*args, x, y, fold_k, block),
                (randn(n), randn(fold_k, nb, nb)))  # A_bar not symmetric
    if core == "nlml":
        return (tloo.ArdNlml.apply(*args, x, y, block),), (randn(1).abs()[0] + 0.5,)
    if core == "es":
        return ((tfold.ard_fold_es_stream(*args, x, y, fold_k, num_sim, 1.0, block, eps=eps),),
                (randn(fold_k),))
    outs = tfold.ard_fold_stats_stream(*args, x, y, fold_k, core == "kc", block)
    return outs, (randn(fold_k, nb), randn(fold_k), randn(fold_k, nb), randn(n))


def _sharded_p1_step(core, args, x, y, fold_k, eps, num_sim, tmp_path):
    """One step of the sharded counterpart on a gloo group of one rank, block
    13 (the sharded path needs n / p to divide by it)."""
    import torch.distributed as dist

    from gpscore_torch.parallel import init_distributed, make_mesh
    from gpscore_torch.parallel.sharded_fold_stream import make_sharded_streamed_kfold_fit_step
    from gpscore_torch.parallel.sharded_loo import (make_sharded_fused_loo_fit_step,
                                                    make_sharded_fused_nlml_fit_step)
    from gpscore_torch.parallel.sharded_potri import make_streamed_ard_bwd
    from gpscore_torch.utils.params import GPParams

    joined = not dist.is_initialized()
    init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh, block = make_mesh(data=1), 13
        params = GPParams(*args, inducing=None)
        if core == "loo":
            make_sharded_fused_loo_fit_step(mesh, block=block)(params, x, y)
        elif core == "nlml":
            make_sharded_fused_nlml_fit_step(mesh, block=block)(params, x, y)
        elif core == "kfold":
            Kinv = tpotri.ard_gram_inverse_inplace(*args, x, block)
            n, nb = x.shape[0], x.shape[0] // fold_k
            cot = (torch.ones(n, dtype=x.dtype), torch.ones((fold_k, nb, nb), dtype=x.dtype))
            make_streamed_ard_bwd(mesh, "kfold", fold_k=fold_k, block=block)(
                Kinv, Kinv @ y, x, *args, cot)
        else:
            make_sharded_streamed_kfold_fit_step(mesh, core, fold_k, block=block,
                                                 num_sim=num_sim)(params, x, y, eps=eps)
    finally:
        if joined:
            dist.destroy_process_group()


@pytest.mark.parametrize("core", STREAM_CORES)
def test_streamed_backward_takes_the_lower_block_triangle(core, monkeypatch, tmp_path):
    """Each single-device core streams only the lower block-triangle of the
    symmetric K_hat_bar (columns [0, r1) of row block [r0, r1)); its
    gradients equal the full-row arithmetic's within 1e-10 in float64 at a
    ragged n (block 16, n = 52). ``STREAM_BLOCKS`` counts only "lower"
    blocks; the Gram backward sees one call a row block with r1 columns; the
    sharded step at p = 1 keeps full rows and counts only "full" blocks."""
    n, block, fold_k, num_sim = 52, 16, 4, 8
    f64 = torch.float64
    x_np, y_np, p = _problem(23, n)
    x, y = t(x_np).to(f64), t(y_np).to(f64).requires_grad_()
    args = [a.to(f64).requires_grad_() for a in _torch_args(p)]
    eps = torch.randn((fold_k, n // fold_k, 2 * num_sim), dtype=f64,
                      generator=torch.Generator().manual_seed(5))
    passes = fold_k if core in FOLD_RULES else 1
    calls = []
    gram_bwd = tgram.gram_bwd

    def spy(xs_b, xps, sig, g):
        calls.append((xs_b.shape[0], xps.shape[0], tuple(g.shape)))
        return gram_bwd(xs_b, xps, sig, g)

    before = dict(tloo.STREAM_BLOCKS)
    outs, cot = _stream_core(core, args, x, y, block, fold_k, eps, num_sim)
    with monkeypatch.context() as m:
        m.setattr(tgram, "gram_bwd", spy)
        got = torch.autograd.grad(outs, args + [y], cot)
    blocks = -(-n // block)
    assert {k: tloo.STREAM_BLOCKS[k] - before[k] for k in before} == \
        {"lower": passes * blocks, "full": 0}
    want_calls = [(min(block, n - r0), min(r0 + block, n), (min(block, n - r0), min(r0 + block, n)))
                  for r0 in range(0, n, block)] * passes
    assert calls == want_calls
    want = _full_row_grads(core, args, x, y.detach(), cot, block, fold_k, eps, num_sim)
    for name, g, w in zip(("log_signal_sq", "log_length", "log_noise_sq", "y"), got, want):
        rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
        assert rel <= 1e-10, (name, rel)

    before = dict(tloo.STREAM_BLOCKS)
    _sharded_p1_step(core, [a.detach() for a in args], x, y.detach(), fold_k, eps, num_sim,
                     tmp_path)
    assert {k: tloo.STREAM_BLOCKS[k] - before[k] for k in before} == \
        {"lower": 0, "full": passes * n // 13}
