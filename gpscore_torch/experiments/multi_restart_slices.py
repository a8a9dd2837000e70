"""multi_restart alone, with its R restarts fitted as P consecutive batched
fits of R/P restarts: the slices that the P 'batch' ranks of a
``torchrun --nproc_per_node=P`` launch of multi_restart fit, in rank order,
on one device.

Its results have multi_restart's layout, so the two runs compare field by
field. Where they are equal, the sharded run's results are its slices'
(each rank fitted its own restarts and the gather put them back in place),
and whatever tells the sharded run from the one-rank one comes from fitting
R/P restarts in a batch rather than R, not from the mesh.

    python -m gpscore_torch.experiments.multi_restart_slices --ranks 4 \\
        [multi_restart's flags]
"""

import argparse

import torch

from gpscore_torch.experiments import multi_restart
from gpscore_torch.fit.train import FitResult
from gpscore_torch.parallel import restart_sweep
from gpscore_torch.utils.params import batch_size


def sliced_sweep(ranks: int):
    """``restart_sweep`` as ``sharded_restart_sweep`` runs it on ``ranks``
    'batch' ranks: one batched fit a slice of R/ranks restarts, each with its
    own default generator, the slices' leaves concatenated in order."""

    def sweep(loss_fn, params_batch, x, y, iters, lr, lr_inducing=None):
        R = batch_size(params_batch)
        if R % ranks != 0:
            raise ValueError(f"{R} restarts do not split over {ranks} ranks")
        r = R // ranks
        fits = [restart_sweep(loss_fn, params_batch.replace(
            **{f: t[i * r:(i + 1) * r].contiguous() for f, t in params_batch.leaves().items()}),
            x, y, iters, lr, lr_inducing) for i in range(ranks)]
        params = fits[0].params.replace(**{f: torch.cat([getattr(fit.params, f) for fit in fits])
                                           for f in fits[0].params.leaves()})
        return FitResult(params, *(torch.cat([getattr(fit, f) for fit in fits])
                                   for f in ("loss_history", "ok")),
                         None, torch.cat([fit.stall_iters for fit in fits]))

    return sweep


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--ranks", type=int, default=4, help="the 'batch' ranks to emulate")
    args, rest = ap.parse_known_args(argv)
    unsliced = multi_restart.restart_sweep
    multi_restart.restart_sweep = sliced_sweep(args.ranks)
    try:
        return multi_restart.main(rest)
    finally:
        multi_restart.restart_sweep = unsliced


if __name__ == "__main__":
    main()
