"""KIN40K full-GP comparison: CRPS / NLML / logs / DSS(4-fold) / ES(4-fold)
(port of `experiments/kin40k_full.py`).

Reproduces `kin40k-FULL-compare.py`: 30 replicates, n_train = 500 rows per
replicate by the reference protocol, the ARD kernel over the 8-d inputs,
random log lengths, random scalars for CRPS and unit scalars for the other
rules (`kin40k-FULL-compare.py:226-233, 321-324`).

    python -m gpscore_torch.experiments.kin40k_full [--replicates 30] [--device cuda]

At --n-train >= 4096 the exact objectives take the fused large-n cores
(gpscore_torch/ops/loo_fused.py for crps, logs and nlml,
gpscore_torch/ops/fold_stream.py for dss and es).
"""

import argparse

from gpscore_torch.experiments.common import (
    add_kin40k_args, add_sweep_args, kin40k_make_data, run_sweep, save_results,
    scaled_schedules)
from gpscore_torch.utils.params import init_rand_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_sweep_args(ap, "kin40k_full", ["crps", "nlml", "logs", "dss", "es"], replicates=30)
    add_kin40k_args(ap)
    args = ap.parse_args(argv)
    make_data = kin40k_make_data(ap, args, fold_rules=("dss", "es"))

    def make_params(generator, d, rule):
        # Per-rule inits of the reference: all-random scalars for CRPS
        # (`kin40k-FULL-compare.py:226-233`), unit scalars elsewhere (`:321-324`).
        return init_rand_params(generator, d, unit_scalars=(rule != "crps"))

    schedules = scaled_schedules("kin40k_full", args.rules, args.iters_scale, args.lr_scale)
    results = run_sweep(
        args.rules, "exact", schedules, make_data, make_params,
        replicates=args.replicates, d=8,
        save_params_dir=args.save_params,
        matmul=args.matmul,
        device=args.device,
    )
    save_results(results, args.out)
    return results


if __name__ == "__main__":
    main()
