"""The port's fold-streamed k-fold cores (gpscore_torch.ops.fold_stream)
against gpscore.ops.fold_stream, the stacked composition and float64.

The JAX side is called directly on the CPU (its Gram is the jnp form there,
no Pallas kernel), with its own auto-resolved path. The energy score runs at
the JAX package's own normals: ``fold_core._fold_eps`` evaluated here and
handed to the port as ``eps``.

Tolerances: values rtol 1e-4, atol 1e-5 (fp32, the same contractions in
another order); gradients rtol 1e-4 with atol 1e-5 + 1e-4 of the leaf's
largest entry, as tests/test_torch_objectives.py takes them (one entry of a
length gradient is a difference of larger terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpscore.fit.objectives as jobjectives
import gpscore.ops.fold_stream as jfold
from gpscore.fit import make_objective as jax_make_objective
from gpscore_torch.fit import make_objective
from gpscore_torch.fit import objectives as tobjectives
from gpscore_torch.models import exact as texact
from gpscore_torch.ops import fold_stream as tfold
from gpscore_torch.ops import linalg as tlinalg
from gpscore_torch.ops import loo_fused as tloo
from gpscore_torch.scoring import rules as trules
from torch_parity import close, jax_params, jax_stream_eps, t, torch_params

RTOL, ATOL = 1e-4, 1e-5
NUM_SIM = 12
SIZES = [(64, 16), (96, 40)]  # (n, block): 96 = 40 + 40 + 16 streams a ragged last block
FOLDS = [2, 4]
KEY = jax.random.PRNGKey(3)


def _problem(seed, n, d=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    p = {"log_signal_sq": np.float32(0.3),
         "log_length": (0.3 * rng.standard_normal(d)).astype(np.float32),
         "log_noise_sq": np.float32(-1.2), "inducing": None}
    return x, y, p


def _leaves(p):
    return [p[f] for f in ("log_signal_sq", "log_length", "log_noise_sq")]


def _torch_args(p, y, dtype=torch.float32):
    return [torch.tensor(v, dtype=dtype, requires_grad=True) for v in (*_leaves(p), y)]


def grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w.detach() if isinstance(w, torch.Tensor) else w)
        close(g, w, RTOL, ATOL + RTOL * float(np.abs(w).max()))


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _weighted(outs, wts, xp):
    return sum(xp.sum(xp.asarray(w) * o) for w, o in zip(wts, outs))


# ---- (a) the two cores against the JAX primitives ----------------------------


@pytest.mark.parametrize("want_inv_diag", [False, True])
@pytest.mark.parametrize("fold_k", FOLDS)
@pytest.mark.parametrize("n,block", SIZES)
def test_fold_stats_stream_matches_jax(n, block, fold_k, want_inv_diag):
    """(e, hld, inv_diag, a) and, through a weighted sum of them, the
    gradients to the three log-parameters and y."""
    x, y, p = _problem(1, n)
    nb = n // fold_k
    wts = _weights(2, [(fold_k, nb), (fold_k,), (fold_k, nb), (n,)])
    xj = jnp.asarray(x)

    def jf(s, ell, nu, yy):
        return _weighted(jfold.ard_fold_stats_stream(s, ell, nu, xj, yy, fold_k,
                                                     want_inv_diag), wts, jnp)

    jargs = [jnp.asarray(v) for v in (*_leaves(p), y)]
    want = jfold.ard_fold_stats_stream(*jargs[:3], xj, jargs[3], fold_k, want_inv_diag)
    want_g = jax.grad(jf, argnums=(0, 1, 2, 3))(*jargs)
    targs = _torch_args(p, y)
    got = tfold.ard_fold_stats_stream(*targs[:3], t(x), targs[3], fold_k, want_inv_diag, block)
    for g, w in zip(got, want):
        close(g, w, RTOL, ATOL)
    if not want_inv_diag:
        assert not got[2].any()
    grads_close(torch.autograd.grad(_weighted(got, [t(w) for w in wts], torch), targs), want_g)


@pytest.mark.parametrize("fold_k", FOLDS)
@pytest.mark.parametrize("n,block", SIZES)
def test_fold_es_stream_matches_jax_at_its_normals(n, block, fold_k):
    x, y, p = _problem(3, n)
    (wts,) = _weights(4, [(fold_k,)])
    xj, key_data = jnp.asarray(x), jax.random.key_data(KEY)

    def jf(s, ell, nu, yy):
        return jnp.sum(jnp.asarray(wts) * jfold.ard_fold_es_stream(
            s, ell, nu, xj, yy, key_data, fold_k, NUM_SIM, 1.0))

    jargs = [jnp.asarray(v) for v in (*_leaves(p), y)]
    want = jfold.ard_fold_es_stream(*jargs[:3], xj, jargs[3], key_data, fold_k, NUM_SIM, 1.0)
    want_g = jax.grad(jf, argnums=(0, 1, 2, 3))(*jargs)
    eps = jax_stream_eps(KEY, fold_k, n // fold_k, NUM_SIM)
    targs = _torch_args(p, y)
    got = tfold.ard_fold_es_stream(*targs[:3], t(x), targs[3], fold_k, NUM_SIM, 1.0, block,
                                   eps=eps)
    close(got, want, RTOL, ATOL)
    grads_close(torch.autograd.grad(torch.sum(t(wts) * got), targs), want_g)


# ---- (b) the objectives --------------------------------------------------------


@pytest.mark.parametrize("kernel", ["ard", "rbf"])
@pytest.mark.parametrize("rule", ["dss", "kc", "es"])
def test_fold_objectives_match_jax_and_the_dense_path(monkeypatch, rule, kernel):
    """make_objective with the fused threshold at 1 on both sides, over a
    ragged stream (n = 96, block 40): against the JAX objective, and against
    the port's own dense kfold_exact_precision path at the same normals."""
    n, d, block, fold_k = 96, 3, 40, 4
    x, y, p = _problem(5, n, d)
    if kernel == "rbf":
        p["log_length"] = np.float32(0.4)
    monkeypatch.setattr(jobjectives, "_FUSED_LOO_MIN_N", 1)
    jloss = jax_make_objective(rule, model="exact", kernel=kernel, fold_k=fold_k,
                               num_sim=NUM_SIM)
    want, want_g = jax.value_and_grad(jloss)(jax_params(p), jnp.asarray(x), jnp.asarray(y), KEY)
    eps = jax_stream_eps(KEY, fold_k, n // fold_k, NUM_SIM)
    kw = {"eps": (eps[..., :NUM_SIM], eps[..., NUM_SIM:])} if rule == "es" else {}
    loss = make_objective(rule, model="exact", kernel=kernel, fold_k=fold_k, num_sim=NUM_SIM,
                          block=block)

    def value_and_grad():
        tp = torch_params(p, requires_grad=True)
        value = loss(tp, t(x), t(y), **kw)
        return value, dict(zip(tp.leaves(), torch.autograd.grad(value, list(tp.leaves().values()))))

    dense, dense_g = value_and_grad()
    monkeypatch.setattr(tobjectives, "_FUSED_LOO_MIN_N", 1)
    got, got_g = value_and_grad()
    close(got, float(want), RTOL)
    close(got, dense.detach().numpy(), RTOL)
    grads_close(got_g.values(), [getattr(want_g, f) for f in got_g])
    grads_close(got_g.values(), dense_g.values())


# ---- (c) the cores against the stacked composition, and float64 ----------------


def _stacked(rule, s, ell, nu, x, y, fold_k, block, eps):
    """The same statistics from the stacked [k, nb, nb] blocks by autograd."""
    a, A = tloo.ard_kfold_solve_blocks(s, ell, nu, x, y, fold_k, block)
    La = tlinalg.chol_factor(A)
    a_b = a.reshape(fold_k, -1)
    e = tlinalg.chol_solve_from_factor(La, a_b[..., None])[..., 0]
    if rule == "es":
        return (trules.energy_score_precision(
            -e, La, torch.zeros_like(e), NUM_SIM, 1.0,
            eps=(eps[..., :NUM_SIM], eps[..., NUM_SIM:])),)
    return e, tlinalg.half_logdet(La), tlinalg.inv_diag_from_chol(La), a


def _streamed(rule, s, ell, nu, x, y, fold_k, block, eps):
    if rule == "es":
        return (tfold.ard_fold_es_stream(s, ell, nu, x, y, fold_k, NUM_SIM, 1.0, block,
                                         eps=eps),)
    return tfold.ard_fold_stats_stream(s, ell, nu, x, y, fold_k, True, block)


@pytest.mark.parametrize("rule", ["stats", "es"])
def test_cores_match_the_stacked_composition(rule):
    n, block, fold_k = 96, 40, 4
    x, y, p = _problem(6, n)
    eps = t(np.random.default_rng(7).standard_normal((fold_k, n // fold_k, 2 * NUM_SIM))
            .astype(np.float32))
    shapes = [(fold_k,)] if rule == "es" else [(fold_k, n // fold_k), (fold_k,),
                                               (fold_k, n // fold_k), (n,)]
    wts = [t(w) for w in _weights(8, shapes)]
    results = []
    for core in (_streamed, _stacked):
        targs = _torch_args(p, y)
        outs = core(rule, *targs[:3], t(x), targs[3], fold_k, block, eps)
        results.append((outs, torch.autograd.grad(_weighted(outs, wts, torch), targs)))
    (got, got_g), (want, want_g) = results
    for g, w in zip(got, want):
        close(g, w.detach().numpy(), RTOL, ATOL)
    grads_close(got_g, want_g)


@pytest.mark.parametrize("rule", ["stats", "es"])
def test_cores_pass_gradcheck_in_float64(rule):
    n, block, fold_k = 48, 20, 4
    x, y, p = _problem(9, n)
    f64 = torch.float64
    eps = t(np.random.default_rng(10).standard_normal((fold_k, n // fold_k, 2 * NUM_SIM)))
    xt = t(x).to(f64)

    def f(s, ell, nu, yy):
        return _streamed(rule, s, ell, nu, xt, yy, fold_k, block, eps)

    assert torch.autograd.gradcheck(f, _torch_args(p, y, f64), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("core", ["stats", "es"])
def test_closed_form_log_signal_gradient_equals_the_streamed_sum(core):
    """The log-signal gradient (the Gram backward's rowsums summed over all
    folds' passes) against its O(n) closed form, rtol 1e-4. K_hat -> e^t K_hat
    moves log-signal and log-noise together, so the two gradients sum to the
    outputs' cotangents against their derivatives in t: e stays, a scales by
    e^-t, inv_diag by e^t, hld falls by nb t / 2, and the es samples
    z = La^-T eps scale by e^(t/2)."""
    n, block, fold_k = 96, 40, 4
    nb = n // fold_k
    x, y, p = _problem(11, n)
    eps = t(np.random.default_rng(12).standard_normal((fold_k, nb, 2 * NUM_SIM))
            .astype(np.float32))
    targs = _torch_args(p, y)
    outs = _streamed(core, *targs[:3], t(x), targs[3], fold_k, block, eps)
    value = sum(torch.sum(torch.sin(o)) for o in outs)
    s_bar, n_bar, *out_bars = torch.autograd.grad(value, (targs[0], targs[2], *outs))
    if core == "stats":
        (_, hld_bar, d_bar, a_bar), (_, _, inv_diag, a) = out_bars, outs
        trace = torch.sum(d_bar * inv_diag) - torch.dot(a_bar, a) - 0.5 * nb * hld_bar.sum()
    else:  # through the samples alone: e, and so r, does not move with t
        with torch.no_grad():
            a, A = tloo.ard_kfold_solve_blocks(*targs[:3], t(x), targs[3], fold_k, block)
            La = tlinalg.chol_factor(A)
            e = tlinalg.chol_solve_from_factor(La, a.reshape(fold_k, nb, 1))[..., 0]
        zT = tlinalg.tri_solve(La, eps, trans=True).requires_grad_()
        scores = torch.stack([tfold._es_from_cols(zT[f], e[f], NUM_SIM, 1.0)
                              for f in range(fold_k)])
        (zT_bar,) = torch.autograd.grad(scores, zT, out_bars[0])
        trace = 0.5 * torch.sum(zT_bar * zT)
    close(s_bar, (trace - n_bar).detach().numpy(), 1e-4)


# ---- (d) errors and failures ---------------------------------------------------


@pytest.mark.parametrize("core", ["stats", "es"])
def test_folds_must_divide_n(core):
    x, y, p = _problem(13, 50)
    targs = _torch_args(p, y)
    with pytest.raises(ValueError, match="not divisible"):
        _streamed(core, *targs[:3], t(x), targs[3], 4, 16, torch.zeros((4, 12, 2 * NUM_SIM)))


@pytest.mark.parametrize("core", ["stats", "es"])
def test_a_fold_that_is_not_spd_gives_nan_and_does_not_raise(core):
    """Duplicate inputs under a vanishing noise: K_hat is singular in fp32,
    the factorizations fail, and values and gradients are NaN."""
    n, fold_k = 32, 4
    x, y, p = _problem(14, n)
    x[1::2] = x[::2]
    p["log_noise_sq"] = np.float32(-60.0)
    eps = torch.ones((fold_k, n // fold_k, 2 * NUM_SIM))
    targs = _torch_args(p, y)
    outs = _streamed(core, *targs[:3], t(x), targs[3], fold_k, 16, eps)
    assert torch.isnan(outs[0]).all()
    grads = torch.autograd.grad(sum(o.sum() for o in outs), targs[:3])
    assert all(torch.isnan(g).all() for g in grads)


def test_es_core_needs_normals_or_a_generator_and_replays_a_seed():
    n, fold_k = 32, 4
    x, y, p = _problem(15, n)
    args = [*(t(v) for v in _leaves(p)), t(x), t(y), fold_k, NUM_SIM, 1.0, 16]
    with pytest.raises(ValueError, match="generator"):
        tfold.ard_fold_es_stream(*args)
    a, b, c = (tfold.ard_fold_es_stream(*args, generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)


# ---- (e) what the cores keep ---------------------------------------------------


@pytest.mark.parametrize("core", ["stats", "es"])
def test_no_stack_of_fold_blocks_is_saved_or_returned(core):
    """Saved for the backward: the n x n inverse and tensors of O(n) and
    O(n num_sim); nothing of k * nb^2 elements, and no [k, nb, nb] output."""
    n, fold_k = 96, 4
    nb = n // fold_k
    x, y, p = _problem(16, n)
    eps = torch.zeros((fold_k, nb, 2)).normal_(generator=torch.Generator().manual_seed(0))
    targs = _torch_args(p, y)
    if core == "es":
        outs = (tfold.ard_fold_es_stream(*targs[:3], t(x), targs[3], fold_k, 1, 1.0, 40,
                                         eps=eps),)
    else:
        outs = tfold.ard_fold_stats_stream(*targs[:3], t(x), targs[3], fold_k, True, 40)
    saved = outs[0].grad_fn.saved_tensors
    assert sum(s.shape == (n, n) for s in saved) == 1
    for s in (*saved, *outs):
        assert s.shape == (n, n) or s.numel() < fold_k * nb * nb, s.shape
        assert s.dim() < 3 or s is eps


def test_kfold_stats_fused_returns_fold_shaped_pieces():
    n, fold_k = 64, 4
    x, y, p = _problem(17, n)
    stats, a_b, y_b = texact.kfold_stats_fused(t(x), t(y), torch_params(p), fold_k,
                                               want_inv_diag=False, block=16)
    assert isinstance(stats, texact.FoldStats)
    assert stats.e.shape == a_b.shape == y_b.shape == (fold_k, n // fold_k)
    assert stats.half_logdet.shape == (fold_k,) and not stats.inv_diag.any()
    dense = texact.kfold_exact_precision(
        texact.gram_cuda.gram_fwd(*(2 * [texact.gram_cuda.scale_inputs(t(x), t(p["log_length"]))]),
                                  torch.exp(t(p["log_signal_sq"]))),
        t(y), torch.exp(t(p["log_noise_sq"])), fold_k)
    close(y_b - stats.e, dense.mean.numpy(), RTOL, ATOL)
    close(stats.half_logdet, tlinalg.half_logdet(dense.chol_prec).numpy(), RTOL)


# ---- (d) the precision modes ----------------------------------------------------


@pytest.mark.parametrize("mode", ["high", "fast", "bf16", "f16"])
@pytest.mark.parametrize("rule", ["dss", "kc", "es"])
def test_fold_cores_in_each_mode_match_jax(monkeypatch, rule, mode):
    """Both cores under each reduced mode against the JAX primitives (in
    place, block 16) under the same matmul_mode: in "bf16"/"f16" K^-1 is
    2-byte on both sides, each fold factored on an fp32 upcast here. "high":
    the fp32 tolerances of (a); "fast" and the 2-byte modes: value rtol 2e-2
    and gradient cosine > 0.999 per leaf (`tests/test_fold_stream.py:124`,
    `:235`). es in "bf16" is held against the JAX core in "highest": XLA's
    CPU backend has no bfloat16 x bfloat16 -> float32 dot for its sample
    products."""
    from gpscore.utils.precision import matmul_mode as jax_matmul_mode
    from gpscore_torch.utils import precision
    from gpscore_torch.utils.precision import matmul_mode

    monkeypatch.setattr(precision, "_SPLIT_MIN_K", 0)  # "high" splits at every size
    n, block, fold_k = 64, 16, 4
    nb = n // fold_k
    x, y, p = _problem(6, n)
    xj, key_data = jnp.asarray(x), jax.random.key_data(KEY)
    eps = jax_stream_eps(KEY, fold_k, nb, NUM_SIM)
    if rule == "es":
        (wts,) = _weights(7, [(fold_k,)])

        def jf(s, ell, nu, yy):
            return jnp.sum(jnp.asarray(wts) * jfold.ard_fold_es_stream(
                s, ell, nu, xj, yy, key_data, fold_k, NUM_SIM, 1.0, block, True))

        def tf(s, ell, nu, yy):
            return torch.sum(t(wts) * tfold.ard_fold_es_stream(
                s, ell, nu, t(x), yy, fold_k, NUM_SIM, 1.0, block, eps=eps))
    else:
        want_inv_diag = rule == "kc"
        wts = _weights(7, [(fold_k, nb), (fold_k,), (fold_k, nb), (n,)])

        def jf(s, ell, nu, yy):
            return _weighted(jfold.ard_fold_stats_stream(s, ell, nu, xj, yy, fold_k,
                                                         want_inv_diag, block, True), wts, jnp)

        def tf(s, ell, nu, yy):
            return _weighted(tfold.ard_fold_stats_stream(s, ell, nu, t(x), yy, fold_k,
                                                         want_inv_diag, block),
                             [t(w) for w in wts], torch)

    jargs = [jnp.asarray(v) for v in (*_leaves(p), y)]
    with jax_matmul_mode("highest" if (rule, mode) == ("es", "bf16") else mode):
        want, want_g = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(*jargs)
    targs = _torch_args(p, y)
    with matmul_mode(mode):
        got = tf(*targs)
        grads = torch.autograd.grad(got, targs)
    assert got.dtype == torch.float32
    if mode == "high":
        close(got, float(want), RTOL, ATOL)
        grads_close(grads, want_g)
        return
    close(got, float(want), 2e-2)
    for g, w in zip(grads, want_g):
        g, w = g.double().numpy().ravel(), np.asarray(w, np.float64).ravel()
        assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999
