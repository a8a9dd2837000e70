"""Batched multi-restart sweep (port of `experiments/multi_restart.py`).

For each requested (rule, inducing count), R random restarts fit as one
batched fit (:func:`gpscore_torch.parallel.restart_sweep`: on a card one
CUDA graph, captured once and replayed, each Gram launch serving all R
restarts), then the best restart by final training loss is evaluated on the
test set. Restarts whose final loss is not finite rank last. As the JAX
script shards the restart axis over a device mesh when it has several
devices, the port shards it over the ranks of a ``torchrun`` launch (or of
a process group the caller made): :func:`gpscore_torch.parallel.sharded_restart_sweep`
on a 'batch' mesh of every rank, NCCL on cards, gloo with ``--device cpu``,
each rank fitting R / world restarts (one rank: bitwise the unsharded
sweep). Alone it runs :func:`~gpscore_torch.parallel.restart_sweep`. Every
rank evaluates the same best restart; rank 0 prints and writes.

The restarts' initial parameters are uniform draws, as the JAX ``init_one``
draws them (log signal, log lengths, log noise and inducing points ~ U(0,
1)), from a CPU generator seeded 0, all R at once
(:func:`gpscore_torch.utils.params.init_rand_params` with ``batch``), then
moved to ``--device``; they are not the JAX package's threefry draws. Each
inducing count draws anew from the same seed.

    python -m gpscore_torch.experiments.multi_restart [--restarts 16]
        [--rules crps nlml] [--model fitc] [--num-inducing 20] [--data DIR]
        [--out results.json] [--device cuda]
    torchrun --nproc_per_node=2 -m gpscore_torch.experiments.multi_restart --device cpu
"""

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from gpscore_torch.data import kin40k_replicate_split, load_kin40k
from gpscore_torch.experiments.common import resolve_device, save_results, synchronize
from gpscore_torch.fit import eval_predictive_metrics, make_objective
from gpscore_torch.fit.schedules import SCHEDULES, rules_for
from gpscore_torch.parallel import init_distributed, make_mesh, restart_sweep, sharded_restart_sweep
from gpscore_torch.utils.params import init_rand_params, select_params

SEED = 0  # the restarts' initial draws (the JAX script's PRNGKey(0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=16)
    ap.add_argument("--rules", nargs="+", default=["crps", "nlml"],
                    choices=rules_for("kin40k_fitc"))
    ap.add_argument("--model", choices=["exact", "fitc"], default="fitc")
    ap.add_argument("--num-inducing", type=int, nargs="+", default=[20],
                    help="FITC inducing counts to sweep (one batched fit per count and "
                         "rule; ignored for --model exact)")
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh, own_group = None, False
    if dist.is_initialized() or "RANK" in os.environ:  # a group, or a torchrun launch
        own_group = not dist.is_initialized()
        device = init_distributed(device)
        mesh = make_mesh(devices=device)
    lead = mesh is None or dist.get_rank() == 0

    s = kin40k_replicate_split(load_kin40k(args.data), 0, device=device)
    x, y, sx, sy = s.train_x, s.train_y, s.test_x, s.test_y
    d = x.shape[1]
    R = args.restarts

    def init_batch(num_inducing):
        p = init_rand_params(torch.Generator().manual_seed(SEED), d,
                             num_inducing=num_inducing if args.model == "fitc" else 0,
                             batch=R)
        return p.replace(**{f: t.to(device) for f, t in p.leaves().items()})

    inducing_counts = args.num_inducing if args.model == "fitc" else [0]
    results = {}
    for m in inducing_counts:
        params_batch = init_batch(m)
        for rule in args.rules:
            sched = SCHEDULES[("kin40k_fitc", rule)]
            loss = make_objective(rule, model=args.model)
            t0 = time.perf_counter()
            if mesh is not None:
                res = sharded_restart_sweep(loss, params_batch, x, y, iters=sched.iters,
                                            lr=sched.lr, mesh=mesh, lr_inducing=sched.lr_inducing)
            else:
                res = restart_sweep(loss, params_batch, x, y, iters=sched.iters, lr=sched.lr,
                                    lr_inducing=sched.lr_inducing)
            final_losses = res.loss_history[:, -1].cpu().numpy()
            fit_s = time.perf_counter() - t0
            # NaN-failed restarts rank last
            ranked = np.where(np.isfinite(final_losses), final_losses, np.inf)
            best = int(ranked.argmin())
            metrics = eval_predictive_metrics(args.model, select_params(res.params, best),
                                              x, y, sx, sy)
            out = {f: float(getattr(metrics, f)) for f in metrics._fields}
            out.update(
                best_restart=best,
                best_final_loss=float(final_losses[best]),
                worst_final_loss=float(np.nanmax(final_losses)),
                num_restarts=R,
                num_failed=int((~np.isfinite(final_losses)).sum()),
            )
            synchronize(device)
            tag = f"{rule}_m{m}" if args.model == "fitc" else rule
            results[tag] = out
            if lead:
                ranks = "" if mesh is None else f" on {mesh.size('batch')} ranks"
                print(f"[{tag}] best restart {best} ({R} restarts x {sched.iters} iterations in "
                      f"{fit_s:.3f} s{ranks}): {json.dumps(out, sort_keys=True)}", flush=True)
    if lead:
        save_results(results, args.out)
    if own_group:
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
