"""The port's sweep machinery, experiment drivers, random inits, synthetic data
and parameter checkpoints against gpscore's.

Tolerances: sweep means rtol 1e-3 (the same fits on both sides, fp32, five GD
steps); synthetic data x exactly, y rtol 1e-4 with atol 1e-4 (one 450 x 450
fp32 Cholesky of condition ~5e3 on each side; the two differ by up to 3e-5);
checkpoints exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpscore.data import sample_synthetic_1d as jax_sample_synthetic_1d
from gpscore.fit import Schedule as JaxSchedule
from gpscore.utils.checkpoint import load_pytree, save_pytree
from gpscore.utils.params import GPParams as JaxParams
from gpscore_torch.data import sample_synthetic_1d
from gpscore_torch.experiments import common, kin40k_fitc, kin40k_full, simple_fitc, simple_full
from gpscore_torch.fit.schedules import SCHEDULES, Schedule
from gpscore_torch.utils.params import (
    FIELDS,
    init_rand_params,
    params_from_checkpoint,
    params_to_numpy,
    save_params_checkpoint,
)
from torch_parity import jax_params, problem, torch_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from experiments.common import run_sweep as jax_run_sweep  # noqa: E402

DRIVERS = {"kin40k_full": kin40k_full, "simple_full": simple_full,
           "kin40k_fitc": kin40k_fitc, "simple_fitc": simple_fitc}


# ---- random inits ------------------------------------------------------------


def test_init_rand_params_draws_from_its_generator():
    a = init_rand_params(torch.Generator().manual_seed(3), 8)
    b = init_rand_params(torch.Generator().manual_seed(3), 8)
    for f in ("log_signal_sq", "log_length", "log_noise_sq"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.log_length.shape == (8,) and a.inducing is None
    assert ((a.log_length >= 0) & (a.log_length < 1)).all()
    assert 0 <= float(a.log_signal_sq) < 1 and 0 <= float(a.log_noise_sq) < 1
    u = init_rand_params(torch.Generator().manual_seed(3), 8, num_inducing=20, unit_scalars=True)
    assert float(u.log_signal_sq) == float(u.log_noise_sq) == 1.0
    assert torch.equal(u.log_length, a.log_length)  # log lengths are drawn first
    assert u.inducing.shape == (20, 8) and (u.inducing >= 0).all()
    nrm = init_rand_params(torch.Generator().manual_seed(3), 8, num_inducing=200,
                           inducing_init="normal")
    assert (nrm.inducing < 0).any() and all(t.dtype == torch.float32
                                            for t in nrm.leaves().values())


def test_replicate_generators_are_seeded_from_seed_and_replicate():
    draw = [torch.rand(4, generator=common.replicate_generator(s, j, *st))
            for s, j, st in [(0, 0, ()), (0, 0, ()), (0, 1, ()), (1, 0, ()), (0, 0, (1,))]]
    assert torch.equal(draw[0], draw[1])
    assert not any(torch.equal(draw[0], d) for d in draw[2:])


# ---- synthetic data ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 700])
def test_synthetic_split_matches_jax_at_its_normals(seed):
    key = jax.random.PRNGKey(seed)
    want = jax_sample_synthetic_1d(key)
    kx, ky = jax.random.split(key)
    eps_x, eps_y = (torch.as_tensor(np.array(jax.random.normal(k, (450,), jnp.float32)))
                    for k in (kx, ky))
    got = sample_synthetic_1d(eps_x=eps_x, eps_y=eps_y)
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if f.endswith("_x"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert got.train_x.shape == (120, 1) and got.test_y.shape == (300,)
    drawn = sample_synthetic_1d(torch.Generator().manual_seed(seed))
    assert torch.isfinite(drawn.train_y).all() and drawn.va_x.shape == (30, 1)


# ---- parameter checkpoints ---------------------------------------------------


def _fitted(with_inducing, replicates=None):
    x, y, p = problem(seed=40, n=8, m=5, d=3)
    if not with_inducing:
        p = dict(p, inducing=None)
    if replicates:
        p = {f: None if v is None else np.stack([v + i for i in range(replicates)])
             for f, v in p.items()}
    return p


@pytest.mark.parametrize("with_inducing,replicates", [(False, None), (True, None), (True, 3),
                                                      (False, 2)])
def test_checkpoints_cross_between_jax_and_the_port(tmp_path, with_inducing, replicates):
    p = _fitted(with_inducing, replicates)
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    save_pytree(jax_file, jax_params(p))
    got = params_to_numpy(params_from_checkpoint(jax_file))
    save_params_checkpoint(port_file, torch_params(p))
    back = load_pytree(port_file, jax_params(p))
    for f in FIELDS:
        if p[f] is None:
            assert got[f] is None and getattr(back, f) is None
        else:
            np.testing.assert_array_equal(got[f], p[f])
            np.testing.assert_array_equal(np.asarray(getattr(back, f)), p[f])
    assert not os.path.exists(port_file + ".tmp")


def test_checkpoint_with_the_wrong_leaf_count_is_refused(tmp_path):
    path = str(tmp_path / "two.npz")
    save_pytree(path, {"a": np.zeros(2), "b": np.ones(())})
    with pytest.raises(ValueError):
        params_from_checkpoint(path)


# ---- run_sweep against the JAX sweep -----------------------------------------


SWEEP_RULES = ["crps", "nlml", "dss"]


def _sweep_inputs():
    def make_data(j):
        x, y, _ = problem(seed=50 + j, n=32, m=1, d=2)
        xs, ys, _ = problem(seed=60 + j, n=16, m=1, d=2)
        return x, y, xs, ys

    fixed = {"log_signal_sq": np.float32(0.2), "log_length": np.array([0.1, -0.2], np.float32),
             "log_noise_sq": np.float32(-1.0), "inducing": None}
    sched = {r: SCHEDULES[("kin40k_full", r)] for r in SWEEP_RULES}
    sched = {r: (s.rule, 5, s.lr) for r, s in sched.items()}
    return make_data, fixed, sched


def test_run_sweep_matches_the_jax_sweep():
    make_data, fixed, sched = _sweep_inputs()
    want = jax_run_sweep(SWEEP_RULES, "exact", {r: JaxSchedule(*s) for r, s in sched.items()},
                         make_data, lambda key, d: jax_params(fixed), replicates=2, d=2,
                         verbose=False)
    got = common.run_sweep(SWEEP_RULES, "exact", {r: Schedule(*s) for r, s in sched.items()},
                           make_data, lambda generator, d: torch_params(fixed), replicates=2,
                           d=2, verbose=False, device="cpu")
    assert got.keys() == want.keys()
    for rule in SWEEP_RULES:
        assert got[rule].keys() == want[rule].keys(), rule
        for f in ("mse", "smse", "logs", "crps", "msll", "coverage95"):
            np.testing.assert_allclose(got[rule][f], want[rule][f], rtol=1e-3, err_msg=f)
        for f in ("num_failed", "num_stalled", "max_stall_iters"):
            assert got[rule][f] == want[rule][f] == 0, (rule, f)
        assert got[rule]["wall_s"] > 0
    for rule in ("crps", "dss"):
        assert got[rule]["paired_vs_nlml"].keys() == want[rule]["paired_vs_nlml"].keys()
        assert got[rule]["paired_vs_nlml"]["n_pairs"] == 2


def test_run_sweep_passes_the_rule_and_saves_the_fits(tmp_path):
    make_data, fixed, sched = _sweep_inputs()
    seen = []

    def make_params(generator, d, rule):
        seen.append((rule, generator.device.type))
        return init_rand_params(generator, d, unit_scalars=(rule != "crps"))

    out = common.run_sweep(["crps", "nlml"], "exact",
                           {r: Schedule(*sched[r]) for r in ("crps", "nlml")}, make_data,
                           make_params, replicates=2, d=2, verbose=False,
                           save_params_dir=str(tmp_path), device="cpu")
    assert seen == [("crps", "cpu")] * 2 + [("nlml", "cpu")] * 2
    assert out["crps"]["num_failed"] == 0 and "paired_vs_nlml" in out["crps"]
    fitted = params_from_checkpoint(str(tmp_path / "crps_params.npz"))
    assert fitted.log_length.shape == (2, 2) and fitted.inducing is None


def test_run_sweep_refuses_a_missing_cuda_device(monkeypatch):
    make_data, fixed, sched = _sweep_inputs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        common.run_sweep(["crps"], "exact", {"crps": Schedule(*sched["crps"])}, make_data,
                         lambda g, d: torch_params(fixed), replicates=1, d=2, device="cuda")


# ---- the four drivers --------------------------------------------------------


def _two_step_schedules():
    return {k: Schedule(s.rule, 2, s.lr, s.lr_inducing) for k, s in SCHEDULES.items()}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_runs_on_the_cpu_when_asked(tmp_path, monkeypatch, name):
    """Each driver's main() with --device cpu, two GD steps per rule (the
    schedule table is cut for the test), writes its results and fitted
    parameters."""
    mod = DRIVERS[name]
    monkeypatch.setattr(common, "SCHEDULES", _two_step_schedules())
    out = tmp_path / "r.json"
    argv = ["--device", "cpu", "--replicates", "2", "--out", str(out),
            "--save-params", str(tmp_path / "p")]
    if name.startswith("kin40k"):
        argv += ["--n-train", "64", "--n-test", "32"]
    res = mod.main(argv)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    rules = {"kin40k_full": ["crps", "nlml", "logs", "dss", "es"],
             "kin40k_fitc": ["crps", "nlml", "logs", "dss", "kc"]}.get(name, ["crps", "nlml", "logs"])
    assert list(res) == rules
    for rule in rules:
        assert res[rule]["num_failed"] == 0
        assert all(np.isfinite(res[rule][f]) for f in ("crps", "logs", "smse", "coverage95"))
        p = params_from_checkpoint(str(tmp_path / "p" / f"{rule}_params.npz"))
        assert (p.inducing is None) == name.endswith("full")


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_refuses_cuda_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DRIVERS[name].main(["--replicates", "1"])


@pytest.mark.parametrize("kind", ["kin40k_full", "kin40k_fitc", "simple_fitc"])
def test_scaled_schedules_scale_iterations_and_rates(kind):
    rules = [r for (k, r) in SCHEDULES if k == kind]
    assert common.scaled_schedules(kind, rules) == {r: SCHEDULES[(kind, r)] for r in rules}
    for r, s in common.scaled_schedules(kind, rules, iters_scale=0.01, lr_scale=0.5).items():
        ref = SCHEDULES[(kind, r)]
        assert s.rule == r and s.iters == max(1, int(ref.iters * 0.01))
        assert s.lr == ref.lr * 0.5
        assert s.lr_inducing == (None if ref.lr_inducing is None else ref.lr_inducing * 0.5)


def test_kin40k_driver_refuses_a_ragged_fold_split():
    with pytest.raises(SystemExit):
        kin40k_full.main(["--device", "cpu", "--n-train", "30", "--rules", "dss"])
