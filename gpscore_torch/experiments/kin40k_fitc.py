"""KIN40K FITC-20 all-rules comparison: CRPS / NLML / logs / DSS / kc (port of
`experiments/kin40k_fitc.py`).

Reproduces `KIN40K-COMPARE-ALL-FITC-20.py`: 10 replicates, n_train = 500, 20
learned inducing points (uniform init, `:215`; normal init for DSS, `:531`),
unit scalars, the reference schedules.

    python -m gpscore_torch.experiments.kin40k_fitc [--replicates 10] [--device cuda]
"""

import argparse

from gpscore_torch.experiments.common import (
    add_kin40k_args, add_sweep_args, kin40k_make_data, run_sweep, save_results,
    scaled_schedules)
from gpscore_torch.utils.params import init_rand_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_sweep_args(ap, "kin40k_fitc", ["crps", "nlml", "logs", "dss", "kc"], replicates=10)
    add_kin40k_args(ap)
    ap.add_argument("--num-inducing", type=int, default=20)
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    make_data = kin40k_make_data(ap, args, fold_rules=("dss", "kc"))
    m = args.num_inducing

    def make_params(generator, d, rule):
        # Random log lengths and unit scalars everywhere
        # (`KIN40K-COMPARE-ALL-FITC-20.py:211-215`); inducing points ~ U(0, 1)
        # except the DSS section's standard-normal draw (`:531`).
        return init_rand_params(generator, d, num_inducing=m, unit_scalars=True,
                                inducing_init="normal" if rule == "dss" else "uniform")

    schedules = scaled_schedules("kin40k_fitc", args.rules, args.iters_scale, args.lr_scale)
    results = run_sweep(
        args.rules, "fitc", schedules, make_data, make_params,
        replicates=args.replicates, d=8,
        save_params_dir=args.save_params,
        matmul=args.matmul,
        device=args.device,
    )
    save_results(results, args.out)
    return results


if __name__ == "__main__":
    main()
