"""Synthetic 1-D FITC comparison with learned inducing points, m = 5 (port of
`experiments/simple_fitc.py`).

Reproduces `SIMPLE-FITC--comapre.py`: the synthetic generator of
:mod:`gpscore_torch.experiments.simple_full`, the FITC model with 5 inducing
points drawn as integers in [-3, 3) (the reference's ``torch.randint``,
`SIMPLE-FITC--comapre.py:200`), the reference schedules.

    python -m gpscore_torch.experiments.simple_fitc [--replicates 100] [--device cuda]
"""

import argparse

import torch

from gpscore_torch.experiments.common import (
    add_sweep_args, run_sweep, save_results, scaled_schedules)
from gpscore_torch.experiments.simple_full import make_data
from gpscore_torch.utils.params import init_unit_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_sweep_args(ap, "simple_fitc", ["crps", "nlml", "logs"], replicates=100)
    ap.add_argument("--num-inducing", type=int, default=5)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    m = args.num_inducing

    def make_params(generator, d):
        u = torch.randint(-3, 3, (m, d), generator=generator).to(torch.float32)
        return init_unit_params(d=d, isotropic=False, inducing=u)

    results = run_sweep(
        args.rules, "fitc", scaled_schedules("simple_fitc", args.rules), make_data,
        make_params, replicates=args.replicates, d=1,
        save_params_dir=args.save_params,
        matmul=args.matmul,
        device=args.device,
    )
    save_results(results, args.out)
    return results


if __name__ == "__main__":
    main()
