"""The RESULTS.md sweep tables through the port, paired per replicate against
the JAX package's fits.

    python -m gpscore_torch.experiments.results_parity --outdir gpscore_torch/results
    python -m gpscore_torch.experiments.results_parity --device cpu --quick

Eight tables (:data:`TABLES`): the four reference protocols (``simple_full``,
``simple_fitc``, ``kin40k_full``, ``kin40k_fitc``) and the four full-pool
ones at n = 9,700 (the exact GP, and FITC at m = 20, 64 and 256), each as
one or more runs of a driver's flags. For each table:

(a) the data, schedules and flags are the port's driver's
    (:func:`~gpscore_torch.experiments.common.kin40k_make_data`,
    :func:`~gpscore_torch.experiments.common.scaled_schedules`); the
    synthetic tables take the JAX package's splits, committed as
    ``gpscore_torch/data/sweeps/synthetic_1d.npz`` (the KIN40K rows are
    already the same: both packages draw them with numpy);
(b) :func:`~gpscore_torch.experiments.common.run_sweep` fits every (rule,
    replicate) on ``--device`` from the JAX package's own initial draw,
    committed under ``gpscore_torch/data/sweeps/<table>_init/``;
(c) for the reference tables, the JAX package's fits on the CPU (committed
    under ``gpscore_torch/data/sweeps/jax_cpu/<table>/``) are evaluated on
    each replicate's test split by the port's evaluation; their means must
    reproduce the JAX run's own means (``[jax-eval]`` lines);
(d) one verdict line per (table, rule, metric in {crps, logs}):

    - paired, for every rule of a reference table whose draws both packages
      share (all but es): with delta_j = port_j - jax_cpu_j, the mean and its
      standard error; it passes at |mean| <= 3 SE + 1e-4;
    - unpaired, for es and for every full-pool table: the port's mean
      against the JAX package's recorded one (``results/*.json``), passing at
      |delta| <= 3 sqrt(se_port^2 + se_jax^2);
    - a single fit (the exact GP's full pool, one replicate): the port's test
      CRPS within 5% of the recorded one;
(e) the port's own paired deltas against NLML (``[vs nlml]`` lines), from
    which the paper's claims are read;
(f) the exit code is 1 if any check failed.

``--outdir`` keeps, per table, the port's results JSON (the drivers'
``--out`` layout), its fitted parameters (``params/<rule>_params.npz``) and
the per-replicate metrics of both sides (``per_replicate.npz``), and
``verdicts.json`` with every check and the card's name and power limit.

es is never paired: its normals come from torch generators, not from the
JAX package's threefry stream. The JAX drafts and fits are written by
``tests/torch_sweeps_export.py`` (see its docstring).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gpscore_torch.experiments.common import (
    kin40k_make_data, resolve_device, run_sweep, scaled_schedules, synchronize)
from gpscore_torch.fit.driver import eval_predictive_metrics
from gpscore_torch.metrics import EvalMetrics
from gpscore_torch.utils.params import params_from_checkpoint, select_params

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS_DIR = os.path.join(_PACKAGE, "data", "sweeps")
RESULTS_DIR = os.path.join(os.path.dirname(_PACKAGE), "results")

METRICS = EvalMetrics._fields
VERDICT_METRICS = ("crps", "logs")
PAIRED_FLOOR = 1e-4
SINGLE_FIT_RTOL = 0.05
JAX_EVAL_RTOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Run:
    """One driver invocation of a table: ``driver``'s ``flags`` (without
    --rules) for ``rules``."""

    driver: str
    flags: Tuple[str, ...]
    rules: Tuple[str, ...]


_POOL = ("--n-train", "9700")
_SLOW = ("--lr-scale", "0.05")  # the sum objectives at ~500/9700 (RESULTS.md:143-180)


def _fitc_pool(m: int, replicates: int) -> Tuple[Run, ...]:
    flags = _POOL + ("--num-inducing", str(m), "--replicates", str(replicates))
    return (Run("kin40k_fitc", flags, ("crps", "logs", "kc", "interval")),
            Run("kin40k_fitc", flags + _SLOW, ("nlml", "dss")))


TABLES: Dict[str, Tuple[Run, ...]] = {
    "simple_full": (Run("simple_full", ("--replicates", "100"),
                        ("crps", "nlml", "logs", "interval")),),
    "simple_fitc": (Run("simple_fitc", ("--replicates", "100"), ("crps", "nlml", "logs")),),
    "kin40k_full": (Run("kin40k_full", ("--replicates", "30"),
                        ("crps", "nlml", "logs", "dss", "es", "interval")),),
    "kin40k_fitc": (Run("kin40k_fitc", ("--replicates", "10"),
                        ("crps", "nlml", "logs", "dss", "kc", "interval")),),
    "kin40k_full_pool": (
        Run("kin40k_full", _POOL + ("--replicates", "1"), ("crps", "logs")),
        Run("kin40k_full", _POOL + ("--replicates", "1") + _SLOW, ("nlml", "dss")),
        Run("kin40k_full", _POOL + ("--replicates", "1") + _SLOW + ("--iters-scale", "20"),
            ("es",)),
    ),
    "kin40k_fitc_pool_m20": _fitc_pool(20, 10),
    "kin40k_fitc_pool_m64": _fitc_pool(64, 5),
    "kin40k_fitc_pool_m256": _fitc_pool(256, 5),
}

# The tables whose JAX sweeps are rerun on the CPU and paired per replicate.
REFERENCE = ("simple_full", "simple_fitc", "kin40k_full", "kin40k_fitc")

# --quick: the smoke's subset, (table, rules).
QUICK = {"simple_full": ("crps", "nlml", "logs"), "kin40k_fitc": ("crps", "nlml")}

# The JAX package's recorded sweeps of each table (results/*.json), read as
# data. Each rule is taken from the first file that has it: the full pool's
# es from the rerun at 20x its iterations (RESULTS.md:160-168), and m = 256
# dss from _b.json, the same fit as _dss.json with its standard errors.
RECORDED = {
    "simple_full": ("simple_full.json", "simple_full_interval.json"),
    "simple_fitc": ("simple_fitc.json",),
    "kin40k_full": ("kin40k_full.json",),
    "kin40k_fitc": ("kin40k_fitc.json", "kin40k_fitc_interval.json"),
    "kin40k_full_pool": ("kin40k_full_pool_es_rerun.json", "kin40k_full_pool.json"),
    "kin40k_fitc_pool_m20": ("kin40k_fitc_fullpool_m20_a.json",
                             "kin40k_fitc_fullpool_m20_b.json"),
    "kin40k_fitc_pool_m64": ("kin40k_fitc_fullpool_m64_a.json",
                             "kin40k_fitc_fullpool_m64_b.json"),
    "kin40k_fitc_pool_m256": ("kin40k_fitc_fullpool_m256_a.json",
                              "kin40k_fitc_fullpool_m256_b.json",
                              "kin40k_fitc_fullpool_m256_dss.json"),
}

# driver -> (model, d)
_DRIVERS = {"simple_full": ("exact", 1), "simple_fitc": ("fitc", 1),
            "kin40k_full": ("exact", 8), "kin40k_fitc": ("fitc", 8)}
_FOLD_RULES = {"kin40k_full": ("dss", "es"), "kin40k_fitc": ("dss", "kc")}


# ---- statistics ----------------------------------------------------------------


def paired_check(port, ref, floor: float = PAIRED_FLOOR) -> dict:
    """The paired test of two per-replicate arrays: delta = port - ref, its
    mean and standard error (ddof 1; None for one pair); passes at |mean| <=
    3 SE + ``floor`` (one pair: |delta| <= floor)."""
    delta = np.asarray(port, np.float64) - np.asarray(ref, np.float64)
    n = int(delta.size)
    mean = float(delta.mean())
    se = float(delta.std(ddof=1) / math.sqrt(n)) if n > 1 else None
    limit = 3.0 * (se or 0.0) + floor
    return {"kind": "paired", "mean": mean, "se": se, "n": n, "limit": limit,
            "ok": bool(abs(mean) <= limit)}


def unpaired_check(mean_port, se_port, mean_ref, se_ref) -> dict:
    """Two means with their standard errors: passes at |delta| <=
    3 sqrt(se_port^2 + se_ref^2)."""
    delta = float(mean_port) - float(mean_ref)
    limit = 3.0 * math.sqrt(float(se_port) ** 2 + float(se_ref) ** 2)
    return {"kind": "unpaired", "mean": delta, "port": float(mean_port),
            "ref": float(mean_ref), "se": math.sqrt(float(se_port) ** 2 + float(se_ref) ** 2),
            "limit": limit, "ok": bool(abs(delta) <= limit)}


def single_fit_check(port, ref, rtol: float = SINGLE_FIT_RTOL) -> dict:
    """One fit on each side: passes at |port - ref| <= rtol |ref|."""
    delta = float(port) - float(ref)
    limit = rtol * abs(float(ref))
    return {"kind": "single fit", "mean": delta, "port": float(port), "ref": float(ref),
            "limit": limit, "ok": bool(abs(delta) <= limit)}


def paired_vs_nlml(per_rep: dict) -> dict:
    """rule -> the paired test-metric deltas against nlml over the replicates
    both fitted (the JAX sweep's ``paired_vs_nlml`` layout)."""
    out = {}
    if "nlml" not in per_rep:
        return out
    base = per_rep["nlml"]
    for rule, rep in per_rep.items():
        both = rep["ok"] & base["ok"]
        if rule == "nlml" or both.sum() < 2:
            continue
        rec = {}
        for f in VERDICT_METRICS:
            c = paired_check(rep[f][both], base[f][both], floor=0.0)
            rec[f + "_delta"], rec[f + "_delta_se"] = c["mean"], c["se"]
        rec["n_pairs"] = int(both.sum())
        out[rule] = rec
    return out


# ---- the JAX package's files ---------------------------------------------------


def recorded_results(table: str, results_dir: str = RESULTS_DIR) -> dict:
    """rule -> the JAX package's recorded means of ``table``."""
    out = {}
    for name in RECORDED[table]:
        with open(os.path.join(results_dir, name)) as f:
            for rule, rec in json.load(f).items():
                out.setdefault(rule, rec)
    return out


def jax_draws(table: str, rule: str, sweeps_dir: str = SWEEPS_DIR):
    """The JAX sweep's initial parameters of ``rule`` in ``table``, [R, ...]."""
    return params_from_checkpoint(os.path.join(sweeps_dir, f"{table}_init", f"{rule}_params.npz"))


def synthetic_make_data(sweeps_dir: str = SWEEPS_DIR):
    """``make_data`` over the JAX synthetic drivers' committed splits."""
    with np.load(os.path.join(sweeps_dir, "synthetic_1d.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def make_data(j):
        return tuple(arrays[k][j] for k in ("train_x", "train_y", "test_x", "test_y"))

    return make_data


# ---- one table -----------------------------------------------------------------


def driver_args(run: Run, extra: Sequence[str] = ()):
    """``run``'s flags (then ``extra``) parsed by its driver's parser."""
    ap = importlib.import_module(f"gpscore_torch.experiments.{run.driver}").parser()
    return ap, ap.parse_args([*run.flags, "--rules", *run.rules, *extra])


def fit_table(table: str, device, rules: Optional[Sequence[str]] = None,
              extra: Sequence[str] = (), sweeps_dir: str = SWEEPS_DIR,
              params_dir: Optional[str] = None, verbose: bool = True) -> dict:
    """(a)-(b): ``table``'s runs through ``run_sweep`` on ``device`` from the
    JAX draws (only ``rules`` where given; ``extra`` flags after the table's).
    Returns {"results": rule -> means, "per_replicate": rule -> {metric:
    [R], "ok": [R]}, "data": [(train_x, train_y, test_x, test_y)] per
    replicate, "model": ..., "wall_s": ...}."""
    results, per_rep, data, model = {}, {}, None, None
    t0 = time.perf_counter()
    for run in TABLES[table]:
        run_rules = tuple(r for r in run.rules if rules is None or r in rules)
        if not run_rules:
            continue
        run = dataclasses.replace(run, rules=run_rules)
        ap, args = driver_args(run, extra)
        model, d = _DRIVERS[run.driver]
        if run.driver.startswith("kin40k"):
            make_data = kin40k_make_data(ap, args, _FOLD_RULES[run.driver])
            schedules = scaled_schedules(run.driver, run.rules, args.iters_scale, args.lr_scale)
        else:
            make_data = synthetic_make_data(sweeps_dir)
            schedules = scaled_schedules(run.driver, run.rules)
        draws = {rule: jax_draws(table, rule, sweeps_dir) for rule in run.rules}
        for rule, p in draws.items():
            if p.log_signal_sq.shape[0] < args.replicates:
                raise ValueError(f"{table} {rule}: {p.log_signal_sq.shape[0]} JAX draws "
                                 f"committed, {args.replicates} replicates asked for")

        def make_params(generator, d, rule, replicate, _draws=draws):
            return select_params(_draws[rule], replicate)

        results.update(run_sweep(
            run.rules, model, schedules, make_data, make_params,
            replicates=args.replicates, d=d, save_params_dir=params_dir,
            matmul=args.matmul, device=device, verbose=verbose, per_replicate=per_rep))
        if data is None:
            data = [tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                          device=resolve_device(device))
                          for a in make_data(j)) for j in range(args.replicates)]
    for rule, rec in paired_vs_nlml(per_rep).items():
        results[rule]["paired_vs_nlml"] = rec
    return {"results": results, "per_replicate": per_rep, "data": data, "model": model,
            "wall_s": time.perf_counter() - t0}


def evaluate_fits(model: str, fitted, data) -> Dict[str, np.ndarray]:
    """(c): metric -> [R], the port's evaluation of replicate j's fitted
    parameters (a [R, ...] GPParams) on replicate j's split."""
    device = data[0][0].device
    rows = []
    for j, split in enumerate(data):
        p = select_params(fitted, j)
        p = p.replace(**{f: t.to(device) for f, t in p.leaves().items()})
        m = eval_predictive_metrics(model, p, *split)
        rows.append([float(v) for v in m])
    arr = np.asarray(rows, np.float64)
    return {f: arr[:, i] for i, f in enumerate(METRICS)}


def jax_eval_check(metrics: Dict[str, np.ndarray], want: dict, n_test: int) -> dict:
    """The means of ``metrics`` against the JAX run's own means ``want``:
    each within ``JAX_EVAL_RTOL`` relative, coverage95 within one test site."""
    worst, ok = {}, True
    for f in METRICS:
        got = float(np.mean(metrics[f]))
        if f == "coverage95":
            good = abs(got - want[f]) <= 1.0 / n_test
            worst[f] = abs(got - want[f])
        else:
            worst[f] = abs(got - want[f]) / abs(want[f])
            good = worst[f] <= JAX_EVAL_RTOL
        ok = ok and bool(good)
    return {"kind": "jax eval", "err": worst, "ok": ok}


def check_table(table: str, fit: dict, sweeps_dir: str = SWEEPS_DIR,
                results_dir: str = RESULTS_DIR):
    """(c)-(d): the checks of one fitted table, as records."""
    port, per_rep = fit["results"], fit["per_replicate"]
    recorded = recorded_results(table, results_dir)
    checks, jax_per_rep = [], {}
    if table in REFERENCE:
        jdir = os.path.join(sweeps_dir, "jax_cpu", table)
        with open(os.path.join(jdir, "results.json")) as f:
            jax_means = json.load(f)
        n_test = int(fit["data"][0][3].numel())
        for rule in port:
            fitted = params_from_checkpoint(os.path.join(jdir, f"{rule}_params.npz"))
            fitted = select_params(fitted, slice(0, len(fit["data"])))
            jax_per_rep[rule] = evaluate_fits(fit["model"], fitted, fit["data"])
            c = jax_eval_check(jax_per_rep[rule], jax_means[rule], n_test)
            checks.append(dict(c, table=table, rule=rule, metric="all"))
    for rule, rec in port.items():
        single = rec.get("crps_se") is None
        for f in VERDICT_METRICS:
            if table in REFERENCE and rule != "es":
                both = per_rep[rule]["ok"] & np.isfinite(jax_per_rep[rule][f])
                c = paired_check(per_rep[rule][f][both], jax_per_rep[rule][f][both])
                c["against"] = "jax_cpu"
            elif single:
                if f != "crps":
                    continue
                c = single_fit_check(rec[f], recorded[rule][f])
                c["against"] = "results"
            else:
                c = unpaired_check(rec[f], rec[f + "_se"], recorded[rule][f],
                                   recorded[rule][f + "_se"])
                c["against"] = "results"
            checks.append(dict(c, table=table, rule=rule, metric=f))
    return checks, jax_per_rep


def format_check(c: dict) -> str:
    head = f"[verdict] {c['table']} {c['rule']} {c['metric']}"
    tail = "pass" if c["ok"] else "FAIL"
    if c["kind"] == "jax eval":
        errs = ", ".join(f"{k} {v:.2g}" for k, v in c["err"].items())
        return (f"[jax-eval] {c['table']} {c['rule']}: the port's evaluation of JAX's CPU "
                f"fits against JAX's means: {errs} (rel, tol {JAX_EVAL_RTOL:g}; coverage95 "
                f"abs, within one test site): {tail}")
    if c["kind"] == "paired":
        se = "n/a" if c["se"] is None else f"{c['se']:.6f}"
        return (f"{head} paired vs JAX CPU: mean delta {c['mean']:+.6f} +- {se} "
                f"({c['n']} pairs), limit {c['limit']:.6f}: {tail}")
    if c["kind"] == "single fit":
        return (f"{head} single fit vs results/: port {c['port']:.5f}, JAX {c['ref']:.5f}, "
                f"delta {c['mean']:+.5f}, limit {c['limit']:.5f} (5%): {tail}")
    return (f"{head} unpaired vs results/: port {c['port']:.5f}, JAX {c['ref']:.5f}, "
            f"delta {c['mean']:+.5f}, limit {c['limit']:.5f} (3 SE): {tail}")


def format_vs_nlml(rec: dict) -> str:
    parts = []
    for f in VERDICT_METRICS:
        mean, se = rec[f + "_delta"], rec[f + "_delta_se"]
        ratio = f"{abs(mean) / se:.1f} SE" if se > 0 else "SE 0"
        parts.append(f"{f} {mean:+.5f} +- {se:.5f} ({ratio})")
    return ", ".join(parts) + f", {rec['n_pairs']} pairs"


def _save_table(outdir: str, table: str, fit: dict, jax_per_rep: dict) -> None:
    os.makedirs(os.path.join(outdir, table), exist_ok=True)
    with open(os.path.join(outdir, table, "results.json"), "w") as f:
        json.dump(fit["results"], f, indent=2, sort_keys=True)
    arrays = {}
    for side, reps in (("port", fit["per_replicate"]), ("jax_cpu", jax_per_rep)):
        for rule, rep in reps.items():
            for k, v in rep.items():
                arrays[f"{side}/{rule}/{k}"] = np.asarray(v)
    np.savez(os.path.join(outdir, table, "per_replicate.npz"), **arrays)


def _pm(mean, se, digits=4):
    return f"{mean:.{digits}f}" + ("" if se is None else f" ± {se:.{digits}f}")


def _vs_jax(c: dict) -> str:
    mark = "" if c["ok"] else " FAIL"
    if c["kind"] == "paired":
        return f"{c['mean']:+.5f} ± {0.0 if c['se'] is None else c['se']:.5f}{mark}"
    tag = "1 fit" if c["kind"] == "single fit" else "unpaired"
    return f"{c['mean']:+.4f} ({tag}, limit {c['limit']:.4f}){mark}"


def markdown_report(outdir: str) -> str:
    """The tables of a run saved in ``outdir``, as PERF.md's markdown: per
    (table, rule) the port's test CRPS and logs with their SEs, the paired
    CRPS delta against NLML, SMSE, MSLL, coverage, wall s, and the deltas of
    test CRPS and logs against the JAX package (paired against its CPU fits,
    else against results/*.json)."""
    with open(os.path.join(outdir, "verdicts.json")) as f:
        verdicts = json.load(f)
    checks = {(c["table"], c["rule"], c["metric"]): c for c in verdicts["checks"]}
    lines = [f"{verdicts['nvidia_smi']}; {verdicts['total_wall_s']:.1f} s in all",
             "",
             "| table | rule | test CRPS ± SE | test logs ± SE | Δ CRPS vs NLML (paired) | SMSE "
             "| MSLL | 95% cov | wall s | Δ CRPS vs JAX | Δ logs vs JAX |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for table in [t for t in TABLES if t in verdicts["wall_s"]]:
        with open(os.path.join(outdir, table, "results.json")) as f:
            res = json.load(f)
        order = [r for run in TABLES[table] for r in run.rules if r in res]
        for rule, rec in ((r, res[r]) for r in order):
            pv = rec.get("paired_vs_nlml")
            vs_nlml = "—" if pv is None else _pm(pv["crps_delta"], pv["crps_delta_se"])
            vs_jax = [_vs_jax(checks[(table, rule, f)]) if (table, rule, f) in checks else "—"
                      for f in VERDICT_METRICS]
            lines.append(
                f"| {table} | {rule} | {_pm(rec['crps'], rec['crps_se'])} | "
                f"{_pm(rec['logs'], rec['logs_se'])} | {vs_nlml} | {rec['smse']:.4f} | "
                f"{rec['msll']:.4f} | {rec['coverage95']:.3f} | {rec['wall_s']:.2f} | "
                f"{vs_jax[0]} | {vs_jax[1]} |")
    failed = [c for c in verdicts["checks"] if not c["ok"]]
    if failed:
        lines += ["", "Failed checks:"] + [f"- {format_check(c)}" for c in failed]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", nargs="+", default=list(TABLES), choices=list(TABLES))
    ap.add_argument("--quick", action="store_true",
                    help="the smoke's subset: " + "; ".join(
                        f"{t} {' '.join(r)}" for t, r in QUICK.items()))
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--outdir", default=None,
                    help="where the results, fits and per-replicate metrics go")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="print the tables of a run saved with --outdir DIR as "
                         "markdown, and stop")
    args = ap.parse_args(argv)
    if args.report:
        print(markdown_report(args.report))
        return 0
    device = resolve_device(args.device)
    smi = None
    if device.type == "cuda":
        from gpscore_torch.bench_gram import nvidia_smi_line
        from gpscore_torch.ops import _build

        smi = nvidia_smi_line()
        t0 = time.perf_counter()
        _build.load_library()  # the kernels' build stays out of the first table's wall
        print(f"[device] {smi}; kernels loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    tables = list(QUICK) if args.quick else args.tables
    checks, walls, t0 = [], {}, time.perf_counter()
    for table in tables:
        params_dir = os.path.join(args.outdir, table, "params") if args.outdir else None
        fit = fit_table(table, device, rules=QUICK[table] if args.quick else None,
                        params_dir=params_dir)
        synchronize(device)
        walls[table] = fit["wall_s"]
        found, jax_per_rep = check_table(table, fit)
        for c in found:
            print(format_check(c), flush=True)
        checks += found
        for rule, rec in fit["results"].items():
            if "paired_vs_nlml" in rec:
                print(f"[vs nlml] {table} {rule}: " + format_vs_nlml(rec["paired_vs_nlml"]),
                      flush=True)
        print(f"[table] {table}: {fit['wall_s']:.2f} s on {device}", flush=True)
        if args.outdir:
            _save_table(args.outdir, table, fit, jax_per_rep)
    failed = sum(not c["ok"] for c in checks)
    summary = {"num_checks": len(checks), "num_failed": failed, "wall_s": walls,
               "total_wall_s": time.perf_counter() - t0, "device": str(device),
               "nvidia_smi": smi}
    print(f"[summary] {json.dumps(summary, sort_keys=True)}", flush=True)
    if args.outdir:
        with open(os.path.join(args.outdir, "verdicts.json"), "w") as f:
            json.dump(dict(summary, checks=checks), f, indent=2, sort_keys=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
