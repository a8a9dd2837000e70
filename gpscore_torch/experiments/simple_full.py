"""Synthetic 1-D full-GP comparison: CRPS-LOO vs NLML vs logs-LOO (port of
`experiments/simple_full.py`).

Reproduces `SIMPLE-DATA FULL-comapre.py`: 100 replicates of n = 120 synthetic
rows, unit log-parameter inits, the reference schedules.

    python -m gpscore_torch.experiments.simple_full [--replicates 100] [--device cuda]

Replicate j's data come from a CPU generator seeded with 100 j (the reference
seeds torch with 100 j, `:159-160`); they are not the JAX package's draws.
"""

import argparse

import torch

from gpscore_torch.data import sample_synthetic_1d
from gpscore_torch.experiments.common import (
    add_sweep_args, run_sweep, save_results, scaled_schedules)
from gpscore_torch.utils.params import init_unit_params


def make_data(j):
    s = sample_synthetic_1d(torch.Generator().manual_seed(100 * j))
    return s.train_x, s.train_y, s.test_x, s.test_y


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_sweep_args(ap, "simple_full", ["crps", "nlml", "logs"], replicates=100)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    def make_params(generator, d):
        return init_unit_params(d=d, isotropic=False)

    results = run_sweep(
        args.rules, "exact", scaled_schedules("simple_full", args.rules), make_data,
        make_params, replicates=args.replicates, d=1,
        save_params_dir=args.save_params,
        matmul=args.matmul,
        device=args.device,
    )
    save_results(results, args.out)
    return results


if __name__ == "__main__":
    main()
