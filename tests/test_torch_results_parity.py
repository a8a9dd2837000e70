"""gpscore_torch.experiments.results_parity against the JAX package's drivers.

The committed JAX draws (gpscore_torch/data/sweeps/, written by
tests/torch_sweeps_export.py) against a fresh capture of the JAX drivers'
closures; a tiny sweep through the port and through the JAX driver from the
same draws; the port's evaluation of the committed JAX CPU fits against the
JAX run's means; the verdict statistics against numpy.

Tolerances: initial parameters and synthetic splits bitwise; the tiny
sweep's fitted parameters and per-replicate metrics rtol 1e-3 (the same fits
on both sides, fp32, a few GD steps: tests/test_torch_experiments.py's sweep
tolerance); the evaluation of JAX's fits rtol 1e-4, coverage95 within one
test site (results_parity's own check).
"""

import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gpscore_torch.experiments import common
from gpscore_torch.experiments import results_parity as rp
from gpscore_torch.fit.schedules import Schedule
from gpscore_torch.utils.params import FIELDS, params_from_checkpoint, params_to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sweeps_export as export  # noqa: E402

from experiments import kin40k_fitc as jax_kin40k_fitc  # noqa: E402
from experiments import kin40k_full as jax_kin40k_full  # noqa: E402
from experiments.common import eval_predictive_metrics as jax_eval  # noqa: E402
from gpscore.utils.checkpoint import load_pytree  # noqa: E402
from gpscore.utils.params import GPParams as JaxParams  # noqa: E402

JAX_DRIVERS = {"kin40k_full": jax_kin40k_full, "kin40k_fitc": jax_kin40k_fitc}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's small tensors: beside the other
    xdist workers, more threads only spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cached_kin40k():
    """The JAX drivers' KIN40K stand-in, synthesized once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        load = functools.lru_cache()(jax_kin40k_full.load_kin40k)
        for mod in JAX_DRIVERS.values():
            mp.setattr(mod, "load_kin40k", load)
        yield


def _leaves(p):
    return {f: v for f, v in params_to_numpy(p).items() if v is not None}


# ---- the committed JAX draws -------------------------------------------------


@pytest.mark.parametrize("table", list(rp.TABLES))
def test_committed_initial_params_are_the_jax_sweeps_draws(table, cached_kin40k):
    for run in rp.TABLES[table]:
        cap = export.capture(run.driver, run.flags, run.rules)
        assert cap["rules"] == list(run.rules)
        for rule in run.rules:
            drawn = export.initial_params(cap, rule)
            want = {f: np.asarray(getattr(drawn, f)) for f in FIELDS
                    if getattr(drawn, f) is not None}
            got = _leaves(rp.jax_draws(table, rule))
            assert got.keys() == want.keys(), rule
            for f in got:
                assert got[f].shape == want[f].shape, (rule, f)
                np.testing.assert_array_equal(got[f], want[f], err_msg=f"{rule} {f}")
            assert got["log_signal_sq"].shape == (cap["replicates"],)


def test_initial_params_equal_the_per_key_draw():
    """jit(vmap(make_params)) over j draws what make_params draws at each key."""
    cap = export.capture("kin40k_fitc", ["--replicates", "3"], ["dss"])
    batched = export.initial_params(cap, "dss")
    for j in range(3):
        one = cap["make_params"](jax.random.fold_in(jax.random.PRNGKey(0), j), 8, rule="dss")
        for f in ("log_length", "inducing"):
            np.testing.assert_array_equal(np.asarray(getattr(batched, f))[j],
                                          np.asarray(getattr(one, f)))


@pytest.mark.parametrize("j", [0, 1, 57, 99])
def test_committed_synthetic_splits_are_the_jax_drivers_data(j):
    cap = export.capture("simple_fitc", ["--replicates", "1"], ["nlml"])
    got = rp.synthetic_make_data()(j)
    for g, w in zip(got, cap["make_data"](j)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (120, 1) and got[3].shape == (300,)


# ---- run_sweep's replicate index ---------------------------------------------


@pytest.mark.parametrize("with_rule", [False, True])
def test_run_sweep_passes_the_replicate_index(with_rule):
    seen = []
    fixed = rp.jax_draws("kin40k_full", "nlml")

    def make_data(j):
        rng = np.random.default_rng(j)
        x = rng.uniform(size=(16, 8)).astype(np.float32)
        return x, x.sum(1), x[:8], x[:8].sum(1)

    if with_rule:
        def make_params(generator, d, rule, replicate):
            seen.append((rule, replicate))
            return rp.select_params(fixed, replicate)
    else:
        def make_params(generator, d, replicate):
            seen.append(replicate)
            return rp.select_params(fixed, replicate)

    sched = {r: Schedule(r, 1, 1e-3) for r in ("nlml", "logs")}
    per_rep = {}
    common.run_sweep(["nlml", "logs"], "exact", sched, make_data, make_params, replicates=3,
                     d=8, verbose=False, device="cpu", per_replicate=per_rep)
    want = [0, 1, 2] * 2
    assert seen == ([(r, j) for r in ("nlml", "logs") for j in range(3)] if with_rule else want)
    assert set(per_rep) == {"nlml", "logs"}
    assert per_rep["nlml"]["crps"].shape == (3,) and per_rep["nlml"]["ok"].all()


# ---- a tiny sweep through both packages --------------------------------------

TINY = ["--replicates", "2", "--n-train", "64", "--iters-scale", "0.005"]
TINY_RULES = {"kin40k_full": ("crps", "dss"), "kin40k_fitc": ("nlml", "kc")}


@pytest.mark.parametrize("table", list(TINY_RULES))
def test_tiny_sweep_matches_the_jax_driver_per_replicate(table, tmp_path, cached_kin40k):
    rules = TINY_RULES[table]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    want = JAX_DRIVERS[table].main(TINY + ["--rules", *rules, "--save-params", str(jdir)])
    got = rp.fit_table(table, "cpu", rules=rules, extra=TINY, params_dir=str(pdir),
                       verbose=False)
    assert list(got["results"]) == list(rules)
    model = got["model"]
    for rule in rules:
        assert got["results"][rule]["num_failed"] == 0
        mine = _leaves(params_from_checkpoint(str(pdir / f"{rule}_params.npz")))
        z = np.zeros(1)
        template = JaxParams(z, z, z, z if model == "fitc" else None)
        theirs = load_pytree(str(jdir / f"{rule}_params.npz"), template)
        for f in mine:
            np.testing.assert_allclose(mine[f], np.asarray(getattr(theirs, f)), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{rule} {f}")
        for j, split in enumerate(got["data"]):
            pj = jax.tree_util.tree_map(lambda a: a[j], theirs)
            m = jax_eval(model, pj, *(np.asarray(a) for a in split))
            for f in rp.METRICS:
                np.testing.assert_allclose(got["per_replicate"][rule][f][j],
                                           float(getattr(m, f)), rtol=1e-3, atol=1e-6,
                                           err_msg=f"{rule} {j} {f}")
        for f in rp.METRICS:
            np.testing.assert_allclose(got["results"][rule][f], want[rule][f], rtol=1e-3,
                                       err_msg=f"{rule} {f}")


# ---- the port's evaluation of the JAX CPU fits -------------------------------


# The one (table, rule) whose fp32 evaluation is ill-conditioned at JAX's
# fits: a few FITC-5 crps fits put inducing points almost on top of each
# other, and two fp32 evaluations of the same parameters part by up to 1e-2
# in a replicate's test logs (the float64 ones agree to 1e-10).
FP32_LIMITED = {("simple_fitc", "crps")}
JAX_EVAL_CASES = [(t, r) for t in rp.REFERENCE for r in rp.TABLES[t][0].rules
                  if (t, r) not in FP32_LIMITED]


@functools.lru_cache()
def _reference(table):
    """(JAX's CPU means, model, per-replicate splits) of a reference table."""
    with open(os.path.join(rp.SWEEPS_DIR, "jax_cpu", table, "results.json")) as f:
        means = json.load(f)
    run = rp.TABLES[table][0]
    ap, args = rp.driver_args(run)
    if run.driver.startswith("kin40k"):
        make_data = common.kin40k_make_data(ap, args, rp._FOLD_RULES[run.driver])
    else:
        make_data = rp.synthetic_make_data()
    data = [tuple(torch.as_tensor(np.asarray(a)) for a in make_data(j))
            for j in range(args.replicates)]
    return means, rp._DRIVERS[run.driver][0], data


def _jax_fits(table, rule):
    return params_from_checkpoint(os.path.join(rp.SWEEPS_DIR, "jax_cpu", table,
                                               f"{rule}_params.npz"))


@pytest.mark.parametrize("table,rule", JAX_EVAL_CASES)
def test_port_evaluation_of_jax_fits_reproduces_the_jax_means(table, rule):
    means, model, data = _reference(table)
    assert set(means) == set(rp.TABLES[table][0].rules)
    assert means[rule]["num_failed"] == 0
    fitted = _jax_fits(table, rule)
    assert fitted.log_signal_sq.shape == (len(data),)
    got = rp.evaluate_fits(model, fitted, data)
    check = rp.jax_eval_check(got, means[rule], n_test=len(data[0][3]))
    assert check["ok"], check


@pytest.mark.parametrize("table,rule", sorted(FP32_LIMITED))
def test_fp32_evaluation_of_these_jax_fits_is_ill_conditioned(table, rule):
    """Both packages in float64 give the same metrics at JAX's fitted
    parameters; each fp32 evaluation misses them, the port's by less than
    JAX's, and the two fp32 means part by more than the [jax-eval] line's
    1e-4 relative: the line fails on fp32 rounding, not on a formula."""
    means, model, data = _reference(table)
    fitted = _jax_fits(table, rule)
    got32 = rp.evaluate_fits(model, fitted, data)
    got64 = rp.evaluate_fits(
        model, fitted.replace(**{f: t.double() for f, t in fitted.leaves().items()}),
        [tuple(a.double() for a in split) for split in data])
    z = np.zeros(1)
    theirs = load_pytree(os.path.join(rp.SWEEPS_DIR, "jax_cpu", table, f"{rule}_params.npz"),
                         JaxParams(z, z, z, z if model == "fitc" else None))
    stacked = [np.stack([np.asarray(split[i], np.float64) for split in data]) for i in range(4)]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, jax.numpy.float64), theirs)
        jax64 = jax.jit(jax.vmap(lambda p, *s: jax_eval(model, p, *s)))(p64, *stacked)
        jax64 = {f: np.asarray(getattr(jax64, f)) for f in rp.METRICS}
    for f in ("logs", "msll", "crps"):
        np.testing.assert_allclose(got64[f], jax64[f], rtol=1e-8, atol=1e-10, err_msg=f)
        truth = float(np.mean(got64[f]))
        port_err = abs(float(np.mean(got32[f])) - truth)
        jax_err = abs(means[rule][f] - truth)
        assert port_err < jax_err, (f, port_err, jax_err)
    gap = abs(float(np.mean(got32["logs"])) - means[rule]["logs"]) / abs(means[rule]["logs"])
    assert gap > rp.JAX_EVAL_RTOL, gap


def test_check_table_holds_the_jax_fits_against_themselves():
    """check_table on a 'port' whose fits are JAX's own: every paired delta
    0, every line passes; es has no pair and is held against results/."""
    table = "kin40k_fitc"
    run = rp.TABLES[table][0]
    ap, args = rp.driver_args(run)
    make_data = common.kin40k_make_data(ap, args, ("dss", "kc"))
    data = [tuple(torch.as_tensor(np.asarray(a)) for a in make_data(j)) for j in range(10)]
    jdir = os.path.join(rp.SWEEPS_DIR, "jax_cpu", table)
    per_rep, results = {}, {}
    for rule in ("crps", "nlml"):
        fitted = params_from_checkpoint(os.path.join(jdir, f"{rule}_params.npz"))
        per_rep[rule] = dict(rp.evaluate_fits("fitc", fitted, data), ok=np.ones(10, bool))
        results[rule] = {f: float(per_rep[rule][f].mean()) for f in rp.METRICS}
    checks, jax_rep = rp.check_table(table, {"results": results, "per_replicate": per_rep,
                                             "data": data, "model": "fitc"})
    kinds = [(c["rule"], c["metric"], c["kind"]) for c in checks]
    assert kinds == [("crps", "all", "jax eval"), ("nlml", "all", "jax eval"),
                     ("crps", "crps", "paired"), ("crps", "logs", "paired"),
                     ("nlml", "crps", "paired"), ("nlml", "logs", "paired")]
    assert all(c["ok"] for c in checks)
    assert all(c["mean"] == 0.0 for c in checks if c["kind"] == "paired")
    assert all("FAIL" not in rp.format_check(c) for c in checks)


# ---- the verdict statistics --------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, 2e-5, 1e-3])
def test_paired_check_equals_numpy(shift):
    rng = np.random.default_rng(5)
    ref = rng.normal(0.2, 0.01, size=30)
    port = ref + shift + rng.normal(0, 1e-4, size=30)
    c = rp.paired_check(port, ref)
    d = port - ref
    se = np.std(d, ddof=1) / np.sqrt(30)
    assert c["n"] == 30 and c["kind"] == "paired"
    np.testing.assert_allclose([c["mean"], c["se"], c["limit"]], [d.mean(), se, 3 * se + 1e-4],
                               rtol=1e-12)
    assert c["ok"] == (abs(d.mean()) <= 3 * se + 1e-4)
    assert c["ok"] == (shift < 1e-3)


def test_paired_check_floor_and_a_single_pair():
    c = rp.paired_check([0.5, 0.5], [0.5 - 9e-5, 0.5 - 9e-5])  # SE 0: the floor decides
    assert c["se"] == 0.0 and c["ok"] and c["limit"] == pytest.approx(1e-4)
    assert not rp.paired_check([0.5, 0.5], [0.4998, 0.4998])["ok"]
    one = rp.paired_check([0.3], [0.30005])
    assert one["se"] is None and one["n"] == 1 and one["ok"]
    assert not rp.paired_check([0.3], [0.3002])["ok"]


@pytest.mark.parametrize("delta,ok", [(0.001, True), (0.004, False)])
def test_unpaired_and_single_fit_checks_equal_numpy(delta, ok):
    c = rp.unpaired_check(0.2 + delta, 0.0008, 0.2, 0.0006)
    limit = 3 * np.hypot(0.0008, 0.0006)
    np.testing.assert_allclose([c["mean"], c["limit"]], [delta, limit], rtol=1e-12)
    assert c["ok"] == ok == (abs(delta) <= limit)
    s = rp.single_fit_check(0.0823 * (1 + 15 * delta), 0.0823)
    assert s["kind"] == "single fit" and s["ok"] == ok
    assert s["limit"] == pytest.approx(0.05 * 0.0823)


def test_paired_vs_nlml_equals_the_sweeps_pairing():
    rng = np.random.default_rng(2)
    reps = {r: {"crps": rng.normal(0.2, 0.01, 6), "logs": rng.normal(0.4, 0.02, 6),
                "ok": np.array([True] * 5 + [r != "dss"])} for r in ("nlml", "crps", "dss")}
    out = rp.paired_vs_nlml(reps)
    assert set(out) == {"crps", "dss"}
    assert out["crps"]["n_pairs"] == 6 and out["dss"]["n_pairs"] == 5
    d = reps["dss"]["logs"][:5] - reps["nlml"]["logs"][:5]
    np.testing.assert_allclose([out["dss"]["logs_delta"], out["dss"]["logs_delta_se"]],
                               [d.mean(), d.std(ddof=1) / np.sqrt(5)], rtol=1e-12)


def test_recorded_results_take_each_rule_from_its_file():
    pool = rp.recorded_results("kin40k_full_pool")
    assert set(pool) == {"crps", "nlml", "logs", "dss", "es"}
    assert pool["es"]["crps"] == pytest.approx(0.08193, abs=1e-5)  # the 20x rerun
    m256 = rp.recorded_results("kin40k_fitc_pool_m256")
    assert set(m256) == {"crps", "nlml", "logs", "dss", "kc", "interval"}
    assert m256["dss"]["crps_se"] is not None
    for table in rp.TABLES:
        assert set(rp.recorded_results(table)) >= {r for run in rp.TABLES[table]
                                                   for r in run.rules}, table


def test_results_parity_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        rp.main(["--quick"])


def test_main_runs_a_table_on_the_cpu_and_writes_its_outputs(tmp_path, monkeypatch, capsys):
    """main() end to end on the CPU: simple_fitc's nlml at its 100 replicates,
    paired against the committed JAX CPU fits; then --report of the outputs."""
    monkeypatch.setattr(rp, "QUICK", {"simple_fitc": ("nlml",)})
    out = tmp_path / "rp"
    assert rp.main(["--quick", "--device", "cpu", "--outdir", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    checks = [ln for ln in lines if ln.startswith(("[verdict]", "[jax-eval]"))]
    assert len(checks) == 3 and all(ln.endswith(": pass") for ln in checks), checks
    summary = json.loads((out / "verdicts.json").read_text())
    assert summary["num_failed"] == 0 and summary["num_checks"] == 3
    assert summary["device"] == "cpu" and summary["nvidia_smi"] is None
    res = json.loads((out / "simple_fitc" / "results.json").read_text())
    assert list(res) == ["nlml"] and res["nlml"]["num_failed"] == 0
    with np.load(out / "simple_fitc" / "per_replicate.npz") as z:
        assert z["port/nlml/crps"].shape == z["jax_cpu/nlml/crps"].shape == (100,)
        np.testing.assert_allclose(z["port/nlml/crps"].mean(), res["nlml"]["crps"], rtol=1e-6)
    fitted = params_from_checkpoint(str(out / "simple_fitc" / "params" / "nlml_params.npz"))
    assert fitted.inducing.shape == (100, 5, 1)
    assert rp.main(["--report", str(out)]) == 0
    table = capsys.readouterr().out
    assert "| simple_fitc | nlml |" in table and "FAIL" not in table


def test_main_exits_one_when_a_check_fails(tmp_path, monkeypatch, capsys):
    def failing(table, fit, **kw):
        checks, jax_rep = real(table, fit, **kw)
        return [dict(checks[0], ok=False)] + checks[1:], jax_rep

    real = rp.check_table
    monkeypatch.setattr(rp, "check_table", failing)
    monkeypatch.setattr(rp, "QUICK", {"simple_fitc": ("nlml",)})
    assert rp.main(["--quick", "--device", "cpu", "--outdir", str(tmp_path)]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert json.loads((tmp_path / "verdicts.json").read_text())["num_failed"] == 1
