"""The port's mesh (gpscore_torch.parallel.mesh), sharded Gram, sharded
restart sweep, the torchrun branch of multi_restart and the dry run, on
spawned gloo ranks, against the JAX package on the virtual 8-device CPU mesh
and against the unsharded port.

One spawn of 4 ranks runs every mesh of this file: ('batch', 'data') =
(4, 1), (2, 2) and (1, 4), so 1, 2 and 4 ranks on 'data' (the Gram) and 4,
2 and 1 on 'batch' (the sweep); one of 2 ranks runs multi_restart
(tests/torch_dist.py: the children import no JAX). Tolerances are JAX's own
(tests/test_parallel.py): the Gram 1e-6, the sweep's loss history 1e-5.
Where the same kernels run on the same inputs (one rank on the axis) the
port's results equal the unsharded port's, run in the same child process,
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from gpscore.fit import make_objective as jax_make_objective
from gpscore.ops.kernels import ard_gram as jax_ard_gram
from gpscore.parallel import make_mesh as jax_make_mesh
from gpscore.parallel import sharded_gram as jax_sharded_gram
from gpscore.parallel import sharded_restart_sweep as jax_sharded_restart_sweep
from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.experiments import multi_restart, multi_restart_slices
from gpscore_torch.fit import SCHEDULES, make_objective
from gpscore_torch.ops.kernels import gram
from gpscore_torch.parallel import restart_sweep
from gpscore_torch.utils.params import params_from_numpy

R, ITERS, LR = 4, 5, 0.3
MR_ITERS, MR_RESTARTS = 3, 4


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    lls = (0.3 * rng.standard_normal(3)).astype(np.float32)
    x_sweep = rng.standard_normal((24, 1)).astype(np.float32)
    y_sweep = (np.sin(x_sweep[:, 0]) + 0.1 * rng.standard_normal(24)).astype(np.float32)
    pb = {"log_signal_sq": np.ones(R, np.float32),
          "log_length": rng.uniform(0, 1, (R, 1)).astype(np.float32),
          "log_noise_sq": np.ones(R, np.float32)}
    return dict(x=x, lls=lls, pb=pb, x_sweep=x_sweep, y_sweep=y_sweep, iters=ITERS, lr=LR)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    inp = _inputs()
    ranks = torch_dist.spawn("mesh", 4, tmp_path_factory.mktemp("mesh"), **inp)
    return inp, ranks


def test_every_rank_returns_the_same_replicated_values(mesh_run):
    _, ranks = mesh_run
    for key in ranks[0]:
        if not key.startswith("coords"):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_mesh_coordinates_follow_jax_layout(mesh_run, shape):
    """Rank r at divmod(r, data), as JAX's devices.reshape(batch, data); the
    sub-groups' first global ranks."""
    _, ranks = mesh_run
    b, d = shape
    for r, res in enumerate(ranks):
        i, j = divmod(r, d)
        assert res[f"coords_{b}x{d}"].tolist() == [i, j, i * d, j]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_gram_matches_jax_and_the_unsharded_port(mesh_run, p):
    inp, ranks = mesh_run
    x, lls = inp["x"], inp["lls"]
    got = ranks[0][f"gram_{p}"]
    want = gram(torch.tensor(x), torch.tensor(x), 0.2, torch.tensor(lls)).numpy()
    if p == 1:
        np.testing.assert_array_equal(got, ranks[0]["gram_unsharded"])
    np.testing.assert_allclose(got, want, atol=1e-6)
    if p > 1:
        mesh = jax_make_mesh(devices=jax.devices()[:p], batch=1, data=p)
        jgot = jax_sharded_gram(jnp.asarray(x), 0.2, jnp.asarray(lls), mesh)
        np.testing.assert_allclose(got, np.asarray(jgot), atol=1e-6)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_gram_gradient_is_the_unsharded_one(mesh_run, p):
    """The all-reduced parameter gradient of sum(K * G) at p ranks equals
    p = 1's (a factor of p would mean a replicated path was reduced) and
    jax.grad of jnp ard_gram (rtol 2e-3, tests/test_parallel.py's gradient
    tolerance)."""
    inp, ranks = mesh_run
    x, lls = inp["x"], inp["lls"]
    G = np.cos(np.arange(x.shape[0] ** 2, dtype=np.float32)).reshape(x.shape[0], x.shape[0])
    want = jax.grad(lambda s, ll: jnp.sum(jax_ard_gram(jnp.asarray(x), jnp.asarray(x), s, ll)
                                          * G), argnums=(0, 1))(jnp.float32(0.2),
                                                                jnp.asarray(lls))
    for key, w in zip(("gram_grad_sig", "gram_grad_ll"), want):
        got = ranks[0][f"{key}_{p}"]
        np.testing.assert_allclose(got, ranks[0][f"{key}_1"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(w), rtol=2e-3, atol=1e-5)


def _jax_sweep(inp, p):
    pb = JaxParams(**{f: jnp.asarray(v) for f, v in inp["pb"].items()}, inducing=None)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(R, dtype=jnp.uint32))
    mesh = jax_make_mesh(devices=jax.devices()[:p], batch=p, data=1)
    return jax_sharded_restart_sweep(jax_make_objective("crps", model="exact"), pb,
                                     jnp.asarray(inp["x_sweep"]), jnp.asarray(inp["y_sweep"]),
                                     iters=ITERS, lr=LR, mesh=mesh, keys=keys)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_restart_sweep_matches_jax_and_restart_sweep(mesh_run, p):
    """R = 4 exact crps restarts, 5 steps: the loss history and the final
    parameters against JAX's sharded sweep on a 'batch' axis of p devices
    (atol 1e-5), and against the unsharded port's restart_sweep, bit for bit
    with one rank on 'batch'."""
    inp, ranks = mesh_run
    res = ranks[0]
    want = restart_sweep(make_objective("crps", model="exact"), params_from_numpy(inp["pb"]),
                         torch.tensor(inp["x_sweep"]), torch.tensor(inp["y_sweep"]),
                         iters=ITERS, lr=LR)
    if p == 1:
        np.testing.assert_array_equal(res["sweep_loss_1"], res["sweep_loss_unsharded"])
    np.testing.assert_allclose(res[f"sweep_loss_{p}"], want.loss_history.numpy(), atol=1e-5)
    jres = _jax_sweep(inp, p)
    np.testing.assert_allclose(res[f"sweep_loss_{p}"], np.asarray(jres.loss_history), atol=1e-5)
    for f in ("log_signal_sq", "log_length", "log_noise_sq"):
        np.testing.assert_allclose(res[f"sweep_{f}_{p}"], np.asarray(getattr(jres.params, f)),
                                   atol=1e-5)


def test_dryrun_legs_run_on_four_ranks(mesh_run):
    _, ranks = mesh_run
    assert ranks[0]["dry_sweep"].shape == (4,)
    assert np.isfinite(ranks[0]["dry_sweep"]).all() and np.isfinite(ranks[0]["dry_steps"]).all()


def test_dryrun_runs_on_one_rank(tmp_path):
    ranks = torch_dist.spawn("dryrun", 1, tmp_path)
    assert ranks[0]["cholesky_rows"].tolist() == [8, 8]
    assert np.isfinite(ranks[0]["steps"]).all()


@pytest.fixture(scope="module")
def mr_ranks(tmp_path_factory):
    """multi_restart.main under 2 gloo ranks (the torchrun branch:
    sharded_restart_sweep, R / 2 restarts a rank), 4 restarts of 3
    iterations, and the path it wrote."""
    tmp = tmp_path_factory.mktemp("multi_restart")
    ranks = torch_dist.spawn("multi_restart", 2, tmp, out_path=str(tmp / "r.json"),
                             iters=MR_ITERS, restarts=MR_RESTARTS)
    return ranks, tmp / "r.json"


@pytest.fixture
def mr_cut(monkeypatch):
    """multi_restart's schedules cut to MR_ITERS iterations in this process."""
    monkeypatch.setattr(multi_restart, "SCHEDULES",
                        {k: dataclasses.replace(s, iters=MR_ITERS) for k, s in SCHEDULES.items()})
    return ["--device", "cpu", "--restarts", str(MR_RESTARTS), "--rules", "crps", "nlml"]


def test_multi_restart_shards_under_two_ranks_as_it_runs_alone(mr_ranks, mr_cut):
    """The 2-rank run against multi_restart's unsharded run in this process:
    the same best restart and the metrics within 1e-5."""
    ranks, out = mr_ranks
    alone = multi_restart.main(mr_cut)
    assert out.exists()
    for tag, rec in alone.items():
        assert int(ranks[0][f"{tag}/best_restart"]) == rec["best_restart"]
        assert int(ranks[1][f"{tag}/num_restarts"]) == MR_RESTARTS
        for k, v in rec.items():
            np.testing.assert_allclose(ranks[0][f"{tag}/{k}"], v, rtol=1e-5, err_msg=k)
            np.testing.assert_array_equal(ranks[1][f"{tag}/{k}"], ranks[0][f"{tag}/{k}"])


def test_multi_restart_slices_are_the_two_rank_run_bit_for_bit(mr_ranks, mr_cut):
    """multi_restart_slices --ranks 2 (the two ranks' restarts as two
    consecutive fits in this process, one intra-op thread as each rank has)
    equals the 2-rank run in every field, and restores restart_sweep."""
    ranks, _ = mr_ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sliced = multi_restart_slices.main(["--ranks", "2", *mr_cut])
    finally:
        torch.set_num_threads(threads)
    assert multi_restart.restart_sweep is restart_sweep
    for tag, rec in sliced.items():
        for k, v in rec.items():
            np.testing.assert_array_equal(ranks[0][f"{tag}/{k}"], np.asarray(v), err_msg=k)
