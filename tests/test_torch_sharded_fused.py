"""The port's in-place sharded K_hat^-1 and fused sharded steps
(gpscore_torch.parallel: sharded_potri, the fused LOO and NLML steps, the
fold-streamed sharded k-fold, bench_sharded) on spawned gloo ranks, against
the JAX package on the virtual 8-device CPU mesh at the same p and against
the port's unsharded single-device counterparts.

One spawn of 4 ranks (tests/torch_dist.py, no JAX in the children) runs
every function at 1, 2 and 4 ranks on 'data' (meshes (4, 1), (2, 2) and
(1, 4)), n = 128, d = 3, block 8; at 4 ranks the k-fold functions also run
at fold_k = 2, where a fold spans two ranks (p > fold_k: the other
contraction order). Tolerances, JAX's own for this stack
(tests/test_sharded_potri.py, tests/test_sharded_fold_stream.py,
tests/test_parallel.py):

- K_hat^-1 against float64 numpy and JAX's, relative to its largest entry:
  fp32 5e-6, bf16 5e-2, f16 1e-2; the half log-det rtol 1e-5 (fp32), atol
  8e-3 n (2-byte). At one rank bitwise the unsharded pipeline.
- The streamed backward against JAX's (fed the port's K_hat^-1) and the
  unsharded fused core's autograd: rtol 2e-4, atol 5e-5 (loo, nlml), atol
  1e-4 (kfold).
- A step's loss rtol 2e-4 and its gradient (read off the update, lr 0.01)
  atol 1e-4, rtol 2e-2 against JAX's step and the unsharded fused
  objective; es (at JAX's own normals) loss rtol 3e-4, gradient atol 3e-4,
  rtol 3e-2; at 2 and 4 ranks against 1 rank's, atol 1e-5, rtol 1e-4.
- The f16 steps against the fp32 step, JAX's f16 step and the unsharded f16
  objective: loss rtol 2e-2, updated parameters rtol 0.1, atol 0.05.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from gpscore.ops import fold_stream as jfold_stream
from gpscore.ops.fold_core import _fold_eps
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.parallel import make_mesh as jax_make_mesh
from gpscore.parallel import (make_sharded_fused_kfold_fit_step as jax_kfold_step,
                              make_sharded_fused_loo_fit_step as jax_loo_step,
                              make_sharded_fused_nlml_fit_step as jax_nlml_step)
from gpscore.parallel.sharded_potri import (ard_gram_inverse_inplace_sharded as jax_potri,
                                            make_streamed_ard_bwd as jax_bwd,
                                            sharded_diag as jax_diag)
from gpscore.utils.params import GPParams as JaxParams
from gpscore.utils.precision import matmul_mode as jax_matmul_mode
from gpscore_torch.experiments.bench_ceiling import fused_from
from gpscore_torch.fit import make_objective
from gpscore_torch.ops import loo_fused
from gpscore_torch.utils.params import params_from_numpy
from gpscore_torch.utils.precision import matmul_mode

N, D, BLOCK, LR, NUM_SIM = 128, 3, 8, 0.01, 16
LEAVES = ("log_signal_sq", "log_length", "log_noise_sq")
KEY = jax.random.PRNGKey(5)
LOO_RULES = ("crps", "logs", "interval")
STORAGE_TOL = {"fp32": 5e-6, "bf16": 5e-2, "f16": 1e-2}


def _eps(fold_k):
    """JAX's es normals at fold_k, [k, nb, 2 NUM_SIM]: ``_fold_eps`` at the
    padded fold size, its first nb rows (what the JAX sharded step draws)."""
    nb = N // fold_k
    kd = jax.random.key_data(KEY)
    pad = jfold_stream._fold_pad(nb)
    return np.stack([np.asarray(_fold_eps(kd, f, pad, NUM_SIM))[:nb] for f in range(fold_k)])


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    p = {"log_signal_sq": np.float32(0.3),
         "log_length": (0.3 * rng.standard_normal(D)).astype(np.float32),
         "log_noise_sq": np.float32(-0.5)}
    cot = {"a_bar": rng.standard_normal(N).astype(np.float32),
           "d_bar": rng.standard_normal(N).astype(np.float32),
           "v_bar": np.float32(1.7),
           "A_bar4": rng.standard_normal((4, N // 4, N // 4)).astype(np.float32),
           "A_bar2": rng.standard_normal((2, N // 2, N // 2)).astype(np.float32)}
    return dict(x=x, y=y, p=p, cot=cot, lr=LR, block=BLOCK, num_sim=NUM_SIM, eps4=_eps(4),
                eps2=_eps(2))


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    inp = _inputs()
    ranks = torch_dist.spawn("fused", 4, tmp_path_factory.mktemp("fused"), timeout=400, **inp)
    return inp, ranks[0], ranks


def _jmesh(p):
    return jax_make_mesh(devices=jax.devices()[:p], batch=1, data=p)


def _jparams():
    return JaxParams(**{f: jnp.asarray(v) for f, v in _inputs()["p"].items()})


def _f64_inverse():
    inp = _inputs()
    p = inp["p"]
    K = np.asarray(jax_ard_gram(jnp.asarray(inp["x"]), jnp.asarray(inp["x"]), p["log_signal_sq"],
                                jnp.asarray(p["log_length"])), np.float64)
    K += np.exp(np.float64(p["log_noise_sq"])) * np.eye(N)
    return np.linalg.inv(K), np.sum(np.log(np.diag(np.linalg.cholesky(K))))


def test_every_rank_returns_the_same_replicated_values(fused):
    _, _, ranks = fused
    for key in ranks[0]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "f16"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_inverse_matches_float64_jax_and_the_unsharded_pipeline(fused, p, storage):
    _, res, _ = fused
    inp = _inputs()
    want, want_hld = _f64_inverse()
    scale = np.abs(want).max()
    got = res[f"potri_{storage}_{p}"]
    tol = STORAGE_TOL[storage]
    assert np.abs(got - want).max() / scale < tol
    if storage == "fp32":
        np.testing.assert_array_equal(got, got.T)  # both triangles written
        np.testing.assert_allclose(res[f"potri_hld_{storage}_{p}"], want_hld, rtol=1e-5)
    else:
        np.testing.assert_allclose(res[f"potri_hld_{storage}_{p}"], want_hld, atol=8e-3 * N)
    st = {"fp32": None, "bf16": jnp.bfloat16, "f16": jnp.float16}[storage]
    pj = inp["p"]
    mesh = _jmesh(p)
    jK, _ = jax.jit(lambda *a: jax_potri(*a, mesh, block=BLOCK, storage=st))(
        pj["log_signal_sq"], jnp.asarray(pj["log_length"]), pj["log_noise_sq"],
        jnp.asarray(inp["x"]))
    assert np.abs(got - np.asarray(jK.astype(jnp.float32))).max() / scale < tol
    if p == 1:
        np.testing.assert_array_equal(got, res[f"potri_unsharded_{storage}"])
    else:
        assert np.abs(got - res[f"potri_unsharded_{storage}"]).max() / scale < tol


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_diag_is_the_diagonal(fused, p):
    _, res, _ = fused
    np.testing.assert_array_equal(res[f"diag_{p}"], np.diag(res[f"potri_fp32_{p}"]))
    got = jax_diag(jnp.asarray(res[f"potri_fp32_{p}"]), _jmesh(p))
    np.testing.assert_array_equal(res[f"diag_{p}"], np.asarray(got))


def _bwd_cases():
    return [(m, fk, p) for p in (1, 2, 4) for m, fk in
            [("loo", None), ("nlml", None), ("kfold", 4)] + ([("kfold", 2)] if p == 4 else [])]


def _unsharded_bwd(mode, fold_k):
    """(s_bar, l_bar, n_bar, y_bar) of the unsharded fused core's autograd for
    the same cotangents (nlml: v_bar times the NLML)."""
    inp = _inputs()
    cot = {k: torch.as_tensor(v) for k, v in inp["cot"].items()}
    leaves = [torch.tensor(inp["p"]["log_signal_sq"]), torch.as_tensor(inp["p"]["log_length"]),
              torch.tensor(inp["p"]["log_noise_sq"]), torch.as_tensor(inp["y"])]
    leaves = [t.clone().requires_grad_() for t in leaves]
    x = torch.as_tensor(inp["x"])
    if mode == "loo":
        a, d = loo_fused.ard_loo_solve_diag(*leaves[:3], x, leaves[3], block=BLOCK)
        v = torch.sum(a * cot["a_bar"]) + torch.sum(d * cot["d_bar"])
    elif mode == "nlml":
        v = cot["v_bar"] * loo_fused.ard_nlml(*leaves[:3], x, leaves[3], block=BLOCK)
    else:
        a, A = loo_fused.ard_kfold_solve_blocks(*leaves[:3], x, leaves[3], fold_k, block=BLOCK)
        v = torch.sum(a * cot["a_bar"]) + torch.sum(A * cot[f"A_bar{fold_k}"])
    return [g.numpy() for g in torch.autograd.grad(v, leaves)]


@pytest.mark.parametrize("mode,fold_k,p", _bwd_cases())
def test_streamed_bwd_matches_jax_and_the_unsharded_core(fused, mode, fold_k, p):
    _, res, _ = fused
    inp = _inputs()
    pj = inp["p"]
    got = [res[f"bwd_{mode}{fold_k or ''}_{i}_{p}"] for i in range(4)]
    Kinv = jnp.asarray(res[f"potri_fp32_{p}"])
    a = jnp.matmul(Kinv, jnp.asarray(inp["y"])[:, None], precision=jax.lax.Precision.HIGHEST)[:, 0]
    cot = inp["cot"]
    if mode == "nlml":
        c = jnp.float32(cot["v_bar"])
    else:
        c = (jnp.asarray(cot["a_bar"]),
             jnp.asarray(cot["d_bar"] if mode == "loo" else cot[f"A_bar{fold_k}"]))
    bwd = jax_bwd(_jmesh(p), mode, fold_k=fold_k, block=BLOCK)
    jb = jax.jit(bwd)(Kinv, a, jnp.asarray(inp["x"]), pj["log_signal_sq"],
                      jnp.asarray(pj["log_length"]), pj["log_noise_sq"], c)
    atol = 1e-4 if mode == "kfold" else 5e-5
    n_out = 3 if mode == "nlml" else 4  # the nlml w is v_bar/2 a, y's cotangent v_bar a
    for i in range(n_out):
        np.testing.assert_allclose(got[i], np.asarray(jb[i]), rtol=2e-4, atol=atol)
    for g, want in zip(got[:n_out], _unsharded_bwd(mode, fold_k)):
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=atol)
    if mode == "nlml":
        np.testing.assert_allclose(got[3], 0.5 * cot["v_bar"] * np.asarray(a), rtol=2e-4,
                                   atol=atol)


def _step_key(rule, fold_k):
    if rule in LOO_RULES:
        return f"loo_{rule}"
    return "nlml" if rule == "nlml" else f"kfold_{rule}{fold_k}"


@functools.lru_cache(maxsize=None)
def _jax_step(rule, fold_k, p, mode="highest"):
    """JAX's fused sharded step at p: (loss, {leaf: updated value})."""
    inp = _inputs()
    mesh = _jmesh(p)
    with jax_matmul_mode(mode):
        if rule in LOO_RULES:
            step = jax_loo_step(mesh, lr=LR, block=BLOCK, rule=rule)
        elif rule == "nlml":
            step = jax_nlml_step(mesh, lr=LR, block=BLOCK)
        else:
            step = jax_kfold_step(mesh, rule=rule, fold_k=fold_k, lr=LR, block=BLOCK,
                                  num_sim=NUM_SIM)
        kw = {"key": KEY} if rule == "es" else {}
        loss, p1 = step(_jparams(), jnp.asarray(inp["x"]), jnp.asarray(inp["y"]), **kw)
    return float(loss), {f: np.asarray(getattr(p1, f)) for f in LEAVES}


@functools.lru_cache(maxsize=None)
def _unsharded_step(rule, fold_k, mode="highest"):
    """The unsharded port's fused objective (the single-device fused and
    fold-streamed cores, block 8): (loss, {leaf: updated value})."""
    inp = _inputs()
    params = params_from_numpy(inp["p"])
    leaves = {f: t.clone().requires_grad_() for f, t in params.leaves().items()}
    kw = {}
    if rule == "es":
        eps = torch.as_tensor(inp[f"eps{fold_k}"])
        kw = {"eps": (eps[..., :NUM_SIM], eps[..., NUM_SIM:])}
    with fused_from(1), matmul_mode(mode):
        loss = make_objective(rule, model="exact", fold_k=fold_k or 4, num_sim=NUM_SIM,
                              block=BLOCK)(params.replace(**leaves), torch.as_tensor(inp["x"]),
                                           torch.as_tensor(inp["y"]), **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {f: (t - LR * g).detach().numpy()
                         for (f, t), g in zip(params.leaves().items(), grads)}


def _grad(p1):
    p0 = _inputs()["p"]
    return {f: (np.asarray(p0[f], np.float64) - p1[f]) / LR for f in LEAVES}


def _step_cases():
    cases = [(r, None, p) for r in LOO_RULES + ("nlml",) for p in (1, 2, 4)]
    cases += [(r, 4, p) for r in ("dss", "kc", "es") for p in (1, 2, 4)]
    return cases + [(r, 2, 4) for r in ("dss", "kc", "es")]


@pytest.mark.parametrize("rule,fold_k,p", _step_cases())
def test_fused_step_matches_jax_and_the_unsharded_objective(fused, rule, fold_k, p):
    _, res, _ = fused
    key = _step_key(rule, fold_k)
    loss0 = res[f"{key}_{p}"]
    got = _grad({f: res[f"{key}_{f}_{p}"] for f in LEAVES})
    rtol, atol, grtol = (3e-4, 3e-4, 3e-2) if rule == "es" else (2e-4, 1e-4, 2e-2)
    for loss, p1 in (_jax_step(rule, fold_k, p), _unsharded_step(rule, fold_k)):
        np.testing.assert_allclose(loss0, loss, rtol=rtol)
        for f, g in _grad(p1).items():
            np.testing.assert_allclose(got[f], g, atol=atol, rtol=grtol, err_msg=f)
    one = _grad({f: res[f"{key}_{f}_1"] for f in LEAVES}) if fold_k != 2 else None
    if one is not None:
        for f in LEAVES:
            np.testing.assert_allclose(got[f], one[f], atol=1e-5, rtol=1e-4, err_msg=f)


@pytest.mark.parametrize("rule", ["crps", "dss"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_f16_step_tracks_fp32_jax_and_the_unsharded_objective(fused, p, rule):
    """The "f16" mode's 2-byte K_hat^-1 through the fused step: at the f16
    grade of the fp32 step, of JAX's f16 step and of the unsharded f16 one."""
    _, res, _ = fused
    fk = None if rule == "crps" else 4
    loss0 = res[f"f16_{rule}_{p}"]
    got = {f: res[f"f16_{rule}_{f}_{p}"] for f in LEAVES}
    key = _step_key(rule, fk)
    refs = [(res[f"{key}_{p}"], {f: res[f"{key}_{f}_{p}"] for f in LEAVES}),
            _jax_step(rule, fk, p, "f16"), _unsharded_step(rule, fk, "f16")]
    for loss, p1 in refs:
        np.testing.assert_allclose(loss0, loss, rtol=2e-2)
        for f in LEAVES:
            np.testing.assert_allclose(got[f], p1[f], rtol=0.1, atol=0.05, err_msg=f)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_collectives_of_a_step_are_the_analytic_count(fused, p):
    """The bytes the crps, nlml and dss steps issued (mesh.COLLECTIVES)
    equal bench_sharded's analytic_collective_bytes."""
    _, res, _ = fused
    assert res[f"collectives_{p}"].tolist() == [True, True, True]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_bad_shapes_raise(fused, p):
    """n not divisible by p * block (the step, the inverse), fold_k not
    dividing n, folds that do not tile a rank's rows: ValueError;
    streamed=False: NotImplementedError naming ROADMAP's "Not to port"."""
    _, res, _ = fused
    assert res[f"bad_shapes_{p}"].tolist() == [True] * 5


def test_dryrun_fused_legs_descend_on_two_ranks(tmp_path):
    """Legs (7)-(12) on 2 ranks: each asserts descent inside the dry run;
    the fused LOO leg starts from the out-of-place LOO leg's loss."""
    ranks = torch_dist.spawn("dryrun", 2, tmp_path)
    r = ranks[0]
    for leg in ("fused_loo_step", "fused_kfold_step", "fused_nlml_step", "fused_es_step",
                "f16_loo_step", "f16_kfold_step"):
        assert r[leg].shape == (2,) and np.isfinite(r[leg]).all() and r[leg][1] < r[leg][0], leg
    np.testing.assert_allclose(r["fused_loo_step"][0], r["steps"][0], rtol=2e-4)
    np.testing.assert_allclose(r["fused_kfold_step"][0], r["steps"][2], rtol=2e-4)


def test_bench_sharded_on_the_cpu(tmp_path):
    """bench_sharded --device cpu at tiny n on one rank: its JSON fields,
    the counted collectives equal to the analytic bytes, and its loss the
    unsharded objective's at the same parameters."""
    from gpscore_torch.experiments import bench_ceiling

    argv = ["--device", "cpu", "--n", "64", "--block", "8", "--rule", "crps", "--repeats", "1"]
    rec = json.loads(str(torch_dist.spawn("bench_sharded", 1, tmp_path, argv=argv)[0]["record"]))
    for k in ("rank_step_s", "step_s", "warmup_s", "single_step_s", "loss", "collectives",
              "analytic_collective_bytes", "analytic_collective_gb", "rank_peak_n2", "peak_n2",
              "rank_compute_s", "rank_collective_s", "busy_by_kind", "device", "nvidia_smi",
              "devices"):
        assert k in rec, k
    assert rec["devices"] == 1 and rec["device"] == "cpu"
    assert rec["peak_n2"] is None and rec["rank_compute_s"] is None and rec["busy_by_kind"] is None
    assert sum(c["bytes"] for c in rec["collectives"].values()) == rec["analytic_collective_bytes"]
    x, y = bench_ceiling.make_data(64, 8)
    want, _ = bench_ceiling.value_and_grad(make_objective("crps", model="exact"),
                                           bench_ceiling._params(0, 8, "cpu"), x, y)
    np.testing.assert_allclose(rec["loss"], float(want), rtol=2e-4)
