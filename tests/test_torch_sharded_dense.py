"""The port's distributed dense stack (gpscore_torch.parallel:
sharded_cholesky and its family, the sharded LOO and k-fold cores and
steps) on spawned gloo ranks, against the JAX package on the virtual
8-device CPU mesh and against the unsharded port; and bench_ceiling
--ref-grad.

One spawn of 4 ranks (tests/torch_dist.py, no JAX in the children) runs
every function at 1, 2 and 4 ranks on 'data' (meshes (4, 1), (2, 2) and
(1, 4)), n = 64, block 8. JAX's tolerances (tests/test_parallel.py): the
Cholesky atol 5e-3 / rtol 2e-3, the half log-det 1e-5, the triangular solve
5e-4, the NLML rtol 2e-5, the LOO moments 2e-3, the solve cores' value rtol
2e-4 and gradient atol 1e-4 / rtol 2e-2, and the same for the steps' losses
and gradients. The gradients at 2 and 4 ranks are also held to 1 rank's at
1e-4: a factor of p in a leaf would mean a replicated path was all-reduced.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from gpscore.fit import make_objective as jax_make_objective
from gpscore.ops import linalg as jlinalg
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.parallel import make_mesh as jax_make_mesh
from gpscore.parallel import make_sharded_kfold_blocks as jax_kfold_blocks
from gpscore.parallel.sharded_cholesky import sharded_cholesky as jax_sharded_cholesky
from gpscore.parallel.sharded_cholesky import sharded_nlml as jax_sharded_nlml
from gpscore.parallel.sharded_cholesky import sharded_tri_solve_lower as jax_tri_solve
from gpscore.parallel.sharded_loo import make_sharded_loo_solve_diag as jax_solve_diag
from gpscore.parallel.sharded_loo import sharded_loo_moments as jax_moments
from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.experiments import bench_ceiling
from gpscore_torch.fit import make_objective
from gpscore_torch.models.exact import loo_exact, nlml_exact
from gpscore_torch.utils.params import params_from_numpy

N, BLOCK, FOLD_K, LR = 64, 8, 4, 0.01
EXACT_RULES = ("crps", "logs", "interval", "nlml", "dss", "kc")
LEAVES = ("log_signal_sq", "log_length", "log_noise_sq")


def _inputs():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, N)).astype(np.float32)
    A = (X @ X.T / N + 3.0 * np.eye(N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    x = rng.standard_normal((N, 2)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    K = np.asarray(jax_ard_gram(jnp.asarray(x), jnp.asarray(x), 0.3, jnp.zeros(2)))
    p = {"log_signal_sq": np.float32(0.5), "log_length": np.zeros(2, np.float32),
         "log_noise_sq": np.float32(0.0)}
    return dict(A=A, b=b, x=x, y=y, K=K, p=p, lr=LR, block=BLOCK, fold_k=FOLD_K)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    inp = _inputs()
    ranks = torch_dist.spawn("dense", 4, tmp_path_factory.mktemp("dense"), **inp)
    return inp, ranks[0], ranks


def _jmesh(p):
    return jax_make_mesh(devices=jax.devices()[:p], batch=1, data=p)


def _jparams(p):
    return JaxParams(**{f: jnp.asarray(v) for f, v in p.items()})


def test_every_rank_returns_the_same_replicated_values(dense):
    _, _, ranks = dense
    for key in ranks[0]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_cholesky_matches_jax_and_torch(dense, p):
    inp, res, _ = dense
    A = inp["A"]
    want = torch.linalg.cholesky(torch.tensor(A)).numpy()
    np.testing.assert_allclose(res[f"chol_{p}"], want, atol=5e-3, rtol=2e-3)
    assert np.all(np.triu(res[f"chol_{p}"], 1) == 0)
    np.testing.assert_allclose(res[f"half_logdet_{p}"], np.sum(np.log(np.diag(want))), rtol=1e-5)
    if p > 1:
        jL = jax_sharded_cholesky(jnp.asarray(A), _jmesh(p), block=BLOCK)
        np.testing.assert_allclose(res[f"chol_{p}"], np.asarray(jL), atol=5e-3, rtol=2e-3)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_tri_solve_matches_jax_and_fp64(dense, p):
    inp, res, _ = dense
    A, b = inp["A"], inp["b"]
    want = np.linalg.solve(np.linalg.cholesky(A.astype(np.float64)), b.astype(np.float64))
    np.testing.assert_allclose(res[f"tri_solve_{p}"], want, atol=5e-4)
    if p > 1:
        mesh = _jmesh(p)
        jx = jax_tri_solve(jax_sharded_cholesky(jnp.asarray(A), mesh, block=BLOCK),
                           jnp.asarray(b), mesh, block=BLOCK)
        np.testing.assert_allclose(res[f"tri_solve_{p}"], np.asarray(jx), atol=5e-4)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_nlml_matches_jax_and_the_unsharded_port(dense, p):
    inp, res, _ = dense
    K, y = inp["K"], inp["y"]
    want = float(nlml_exact(torch.tensor(K), torch.tensor(y), 0.25))
    np.testing.assert_allclose(res[f"nlml_{p}"], want, rtol=2e-5)
    if p > 1:
        got = jax_sharded_nlml(jnp.asarray(K), jnp.asarray(y), 0.25, _jmesh(p), block=BLOCK)
        np.testing.assert_allclose(res[f"nlml_{p}"], float(got), rtol=2e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_loo_moments_match_jax_and_loo_exact(dense, p):
    inp, res, _ = dense
    K, y = inp["K"], inp["y"]
    mean, var = res[f"moments_{p}"]
    want = loo_exact(torch.tensor(K), torch.tensor(y), 0.25)
    np.testing.assert_allclose(mean, want.mean.numpy(), atol=2e-3)
    np.testing.assert_allclose(var, want.cov.numpy(), rtol=2e-3)
    if p > 1:
        jm, jv = jax_moments(jnp.asarray(K), jnp.asarray(y), 0.25, _jmesh(p), block=BLOCK)
        np.testing.assert_allclose(mean, np.asarray(jm), atol=2e-3)
        np.testing.assert_allclose(var, np.asarray(jv), rtol=2e-3)


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_loo_solve_diag_value_and_grad_match_jax(dense, p):
    """sum(sin(a) / d) and its gradient in K, as tests/test_parallel.py."""
    inp, res, _ = dense
    A, b = jnp.asarray(inp["A"]), jnp.asarray(inp["b"])
    f = jax_solve_diag(_jmesh(p), block=BLOCK)

    def obj(K):
        a, d = f(K, b)
        return jnp.sum(jnp.sin(a) / d)

    v, g = jax.value_and_grad(obj)(A)
    np.testing.assert_allclose(res[f"solve_diag_{p}"], float(v), rtol=2e-4)
    np.testing.assert_allclose(res[f"solve_diag_grad_{p}"], np.asarray(g), atol=1e-4, rtol=2e-2)
    np.testing.assert_allclose(res[f"solve_diag_grad_{p}"], res["solve_diag_grad_1"],
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_kfold_blocks_value_and_grad_match_jax_and_dense(dense, p):
    """sum(sin(a)) + sum(cos(A)) and its gradient in K against JAX's
    sharded blocks and autodiff through the dense inverse (symmetric parts:
    K is always built symmetric)."""
    inp, res, _ = dense
    A, b = jnp.asarray(inp["A"]), jnp.asarray(inp["b"])
    nb = N // FOLD_K

    def dense_blocks(K, y):
        Kinv = jlinalg.spd_inverse(K)
        blocks = Kinv.reshape(FOLD_K, nb, FOLD_K, nb)
        return Kinv @ y, jnp.stack([blocks[i, :, i, :] for i in range(FOLD_K)])

    def obj(f, K):
        a, Ab = f(K, b)
        return jnp.sum(jnp.sin(a)) + jnp.sum(jnp.cos(Ab))

    sym = lambda g: (np.asarray(g) + np.asarray(g).T) / 2
    for f in (jax_kfold_blocks(_jmesh(p), fold_k=FOLD_K, block=BLOCK), dense_blocks):
        v, g = jax.value_and_grad(lambda K: obj(f, K))(A)
        np.testing.assert_allclose(res[f"kfold_blocks_{p}"], float(v), rtol=2e-4)
        np.testing.assert_allclose(sym(res[f"kfold_blocks_grad_{p}"]), sym(g), atol=1e-4,
                                   rtol=2e-2)


@functools.lru_cache(maxsize=None)
def _references(rule):
    """(value, {leaf: gradient}) of ``rule``'s exact objective at the
    problem's parameters: jax.value_and_grad of JAX's (what its
    GSPMD-sharded function computes), and the unsharded port's."""
    inp = _inputs()
    x, y, p0 = inp["x"], inp["y"], inp["p"]
    jv, jg = jax.value_and_grad(jax_make_objective(rule, model="exact"))(
        _jparams(p0), jnp.asarray(x), jnp.asarray(y), None)
    tp = params_from_numpy(p0)
    leaves = {f: t.clone().requires_grad_() for f, t in tp.leaves().items()}
    tv = make_objective(rule, model="exact")(tp.replace(**leaves), torch.tensor(x),
                                              torch.tensor(y))
    tg = torch.autograd.grad(tv, list(leaves.values()))
    return ((float(jv), {f: np.asarray(getattr(jg, f)) for f in LEAVES}),
            (float(tv.detach()), {f: g.numpy() for f, g in zip(leaves, tg)}))


@pytest.mark.parametrize("rule", EXACT_RULES)
@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_loo_value_and_grad_matches_jax_and_make_objective(dense, p, rule):
    """Every exact rule through the sharded stack against JAX's objective
    and the unsharded port's make_objective; the gradient at p ranks
    against 1 rank's."""
    _, res, _ = dense
    for value, grads in _references(rule):
        np.testing.assert_allclose(res[f"vg_{rule}_{p}"], value, rtol=2e-4)
        for f in LEAVES:
            np.testing.assert_allclose(res[f"vg_{rule}_{f}_{p}"], grads[f], atol=1e-4,
                                       rtol=2e-2)
    for f in LEAVES:
        np.testing.assert_allclose(res[f"vg_{rule}_{f}_{p}"], res[f"vg_{rule}_{f}_1"], atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_es_runs_and_requires_a_generator(dense, p):
    _, res, _ = dense
    assert res[f"es_needs_generator_{p}"]
    assert res[f"vg_es_finite_{p}"]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_fitc_runs_replicated(dense, p):
    """FITC under a mesh: the plain objective on the gathered x on every
    rank, its gradient not reduced, equal to the unsharded port and JAX."""
    inp, res, _ = dense
    x, y = inp["x"], inp["y"]
    pf = dict(inp["p"], inducing=x[:5].copy())
    jv, jg = jax.value_and_grad(jax_make_objective("crps", model="fitc"))(
        _jparams(pf), jnp.asarray(x), jnp.asarray(y), None)
    np.testing.assert_allclose(res[f"fitc_{p}"], float(jv), rtol=2e-4)
    for f in LEAVES + ("inducing",):
        np.testing.assert_allclose(res[f"fitc_{f}_{p}"], np.asarray(getattr(jg, f)), atol=1e-4,
                                   rtol=2e-2)
        np.testing.assert_array_equal(res[f"fitc_{f}_{p}"], res[f"fitc_{f}_1"])


def _jax_step(rule, inp):
    """JAX's loss and one SGD update from the problem's parameters."""
    (v, g), _ = _references(rule)
    return v, {f: inp["p"][f] - LR * g[f] for f in LEAVES}


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_loo_fit_step_matches_the_objective(dense, p):
    inp, res, _ = dense
    want0, p1 = _jax_step("crps", inp)
    np.testing.assert_allclose(res[f"loo_step_{p}"], want0, rtol=2e-4)
    for f in LEAVES:
        np.testing.assert_allclose(res[f"loo_step_{f}_{p}"], p1[f], atol=1e-4, rtol=2e-2)


@pytest.mark.parametrize("rule", ["dss", "kc"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_kfold_fit_step_matches_the_objective_and_descends(dense, p, rule):
    inp, res, _ = dense
    want0, p1 = _jax_step(rule, inp)
    loss0, loss1 = res[f"kfold_step_{rule}_{p}"]
    np.testing.assert_allclose(loss0, want0, rtol=2e-4)
    assert loss1 < loss0
    for f in LEAVES:
        np.testing.assert_allclose(res[f"kfold_step_{rule}_{f}_{p}"], p1[f], atol=1e-4,
                                   rtol=2e-2)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_bad_shapes_raise(dense, p):
    """n not divisible by p * block (Cholesky, triangular solve), fold_k not
    dividing n, batch * data not the world size: each a ValueError."""
    _, res, _ = dense
    assert res[f"bad_shapes_{p}"].tolist() == [True, True, True, True]


@pytest.mark.parametrize("rule", ["crps", "es"])
def test_bench_ceiling_ref_grad_reads_zero_under_highest(rule):
    rec = bench_ceiling.main(["--device", "cpu", "--n", "96", "--rule", rule, "--repeats", "1",
                              "--ref-grad"])
    assert (rec["value_rel_err"], rec["grad_max_rel"]) == (0.0, 0.0)
    assert rec["grad_cos"] == pytest.approx(1.0, abs=1e-12)
