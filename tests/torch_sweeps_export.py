"""Export the JAX package's sweep draws and CPU fits for
``gpscore_torch.experiments.results_parity``.

The JAX drivers (``experiments/{simple_full, simple_fitc, kin40k_full,
kin40k_fitc}.py``) build their ``make_params`` and ``make_data`` closures
inside ``main(argv)``. This helper calls ``main`` with a table's flags, with
the driver module's ``run_sweep`` name swapped for a stub that keeps the
closures and stops, so no JAX file changes. It then writes, under
``gpscore_torch/data/sweeps/``:

- ``<table>_init/<rule>_params.npz``: the captured ``make_params`` at the
  sweep's keys, ``fold_in(PRNGKey(0), j)`` for each replicate j, evaluated as
  the sweep evaluates it (``jit(vmap(...))``), stacked over replicates in the
  ``save_pytree`` layout that ``gpscore_torch.utils.params.params_from_checkpoint``
  reads;
- ``synthetic_1d.npz``: the synthetic drivers' splits, ``make_data(j)`` for
  j < 100, stacked over replicates;
- with ``jax-cpu``, ``jax_cpu/<table>/``: the JAX drivers of the four
  reference tables run on the CPU, their ``--out`` JSON (``results.json``)
  and ``--save-params`` fits (``<rule>_params.npz``); each rule runs as
  its own sweep (``part_<rule>.json``), merged into ``results.json``.

    JAX_PLATFORMS=cpu python tests/torch_sweeps_export.py draws
    JAX_PLATFORMS=cpu python tests/torch_sweeps_export.py jax-cpu --tables kin40k_fitc \
        --rules crps

The JAX CPU sweeps are the slow part. A JAX CPU fit at these sizes is bound
by one thread, so run one process per (table, rule), each pinned to a core
of its own from its start (``taskset -c K``: the CPU runtime sizes its thread
pools from the affinity mask; unpinned processes side by side spin those
pools against each other, ten times slower), with
``XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"``.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gpscore.utils.checkpoint import save_pytree  # noqa: E402
from gpscore_torch.experiments.results_parity import REFERENCE, SWEEPS_DIR, TABLES  # noqa: E402

SYNTHETIC_REPLICATES = 100


class _Captured(Exception):
    pass


def capture(driver: str, flags, rules):
    """The arguments that ``experiments/<driver>.py``'s ``main`` passes to
    ``run_sweep`` under ``flags`` and ``--rules rules``: a dict with
    ``rules``, ``model``, ``schedules``, ``make_data``, ``make_params``,
    ``replicates``, ``d`` and ``kwargs``."""
    mod = importlib.import_module(f"experiments.{driver}")
    seen = {}

    def stub(rules, model, schedules, make_data, make_params, replicates, d, **kwargs):
        seen.update(rules=list(rules), model=model, schedules=schedules,
                    make_data=make_data, make_params=make_params,
                    replicates=replicates, d=d, kwargs=kwargs)
        raise _Captured

    real = mod.run_sweep
    mod.run_sweep = stub
    try:
        mod.main(list(flags) + ["--rules", *rules])
    except _Captured:
        pass
    finally:
        mod.run_sweep = real
    return seen


def initial_params(cap, rule: str, seed: int = 0):
    """``rule``'s initial parameters of every replicate, as JAX ``run_sweep``
    draws them: ``make_params(fold_in(PRNGKey(seed), j), d)``, the rule passed
    where ``make_params`` takes one, under ``jit(vmap(...))`` over j."""
    mp, d = cap["make_params"], cap["d"]
    takes_rule = "rule" in inspect.signature(mp).parameters

    def one(j):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), j)
        return mp(key, d, rule=rule) if takes_rule else mp(key, d)

    return jax.jit(jax.vmap(one))(jnp.arange(cap["replicates"]))


def synthetic_splits(replicates: int = SYNTHETIC_REPLICATES):
    """The synthetic drivers' ``make_data(j)`` for j < ``replicates``, stacked:
    train_x [R, 120, 1], train_y [R, 120], test_x [R, 300, 1], test_y [R, 300]."""
    cap = capture("simple_full", ["--replicates", str(replicates)], ["nlml"])
    data = [cap["make_data"](j) for j in range(replicates)]
    names = ("train_x", "train_y", "test_x", "test_y")
    return {f: np.stack([np.asarray(rep[i]) for rep in data]) for i, f in enumerate(names)}


def export_draws(tables, outdir: str = SWEEPS_DIR) -> None:
    for table in tables:
        for run in TABLES[table]:
            cap = capture(run.driver, run.flags, run.rules)
            for rule in run.rules:
                path = os.path.join(outdir, f"{table}_init", f"{rule}_params.npz")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_pytree(path, initial_params(cap, rule))
                print(f"wrote {path}", flush=True)
    if any(t.startswith("simple_") for t in tables):
        path = os.path.join(outdir, "synthetic_1d.npz")
        np.savez(path, **synthetic_splits())
        print(f"wrote {path}", flush=True)


def export_jax_cpu(tables, outdir: str = SWEEPS_DIR, rules=None) -> None:
    """Run each table's JAX drivers on the CPU with --save-params and --out,
    one rule at a time (``rules``: only those); every part's JSON found in
    ``jax_cpu/<table>/`` is then merged into its ``results.json``. Each
    rule's sweep is its own program, keyed by the replicate alone, so a rule
    run alone fits what it fits beside the others."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for table in tables:
        out = os.path.join(outdir, "jax_cpu", table)
        os.makedirs(out, exist_ok=True)
        for run in TABLES[table]:
            for rule in run.rules:
                if rules and rule not in rules:
                    continue
                cmd = [sys.executable, os.path.join(ROOT, "experiments", f"{run.driver}.py"),
                       *run.flags, "--rules", rule, "--out",
                       os.path.join(out, f"part_{rule}.json"), "--save-params", out]
                t0 = time.time()
                subprocess.run(cmd, check=True, env=env, cwd=ROOT)
                print(f"[{table}] {' '.join(cmd[1:])}: {time.time() - t0:.1f} s", flush=True)
        merged = {}
        for name in sorted(os.listdir(out)):
            if name.startswith("part_") and name.endswith(".json"):
                with open(os.path.join(out, name)) as f:
                    merged.update(json.load(f))
        tmp = os.path.join(out, f"results.json.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=2, sort_keys=True)
        os.replace(tmp, os.path.join(out, "results.json"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["draws", "jax-cpu"])
    ap.add_argument("--tables", nargs="+", default=None, choices=list(TABLES))
    ap.add_argument("--rules", nargs="+", default=None,
                    help="jax-cpu: only these rules (one process per rule and table "
                         "runs the rules side by side)")
    ap.add_argument("--outdir", default=SWEEPS_DIR)
    args = ap.parse_args(argv)
    if args.what == "draws":
        export_draws(args.tables or list(TABLES), args.outdir)
    else:
        export_jax_cpu(args.tables or list(REFERENCE), args.outdir, args.rules)


if __name__ == "__main__":
    main()
