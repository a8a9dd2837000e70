"""The fused sharded fit step, timed on every rank beside the single-device
step (port of `experiments/bench_sharded.py`).

    python -m gpscore_torch.experiments.bench_sharded --n 30720 --block 256 --rule crps
    torchrun --nproc_per_node=4 -m gpscore_torch.experiments.bench_sharded --rows 30720 --rule dss
    python -m gpscore_torch.experiments.bench_sharded --device cpu --n 64 --block 8

p is the world size: under ``torchrun`` every rank is one card of 'data';
alone, a group of one rank. Every rank builds the fused sharded step of
``--rule`` (:mod:`gpscore_torch.parallel`; lr 0) and times it as
:mod:`~gpscore_torch.experiments.bench_ceiling` times its step: one warm-up
step, then ``--repeats`` steps at new parameters, each between device
synchronizations, the fastest kept. Rank 0 prints one JSON line:

- ``rank_step_s``: each rank's fastest step; ``step_s`` the slowest of them;
  ``warmup_s`` and ``loss`` of the warm-up step;
- ``single_step_s``: bench_ceiling's single-device value-and-grad at the
  same (n, block, matmul), on rank 0's device, timed the same way;
- ``rank_peak_n2``: each rank's ``max_memory_allocated`` over one step, in
  n^2 * 4 bytes (null on the CPU); ``peak_n2`` the largest;
- ``rank_compute_s`` and ``rank_collective_s``: each rank's device time in
  a profiled step (``bench_ceiling.device_profile``) in kernels other than
  NCCL's, and in NCCL's, which run on their own stream beside the others
  and include the wait for the slowest rank: the balance of the ranks'
  work; ``busy_by_kind``: rank 0's by kind of kernel; null on the CPU;
- ``collectives``: what rank 0 issued in one step, by kind, the count and
  the bytes of their output on the rank (``parallel.mesh.COLLECTIVES``;
  every rank issues the same); ``analytic_collective_bytes``: the same total
  from the stages' message sizes (:func:`analytic_collective_bytes`);
- ``device`` and the card's ``nvidia_smi`` name and power limit.

Not ported: ``--hlo-collectives`` (a census of XLA's HLO, which torch does
not have: the counter above takes its place), ``--project`` and
``--ici-gbps`` (a projection of the TPU's inter-chip links; four cards time
p = 2 and 4 directly), and ``--devices`` (the world size is p).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from gpscore_torch.bench_gram import nvidia_smi_line
from gpscore_torch.experiments import bench_ceiling
from gpscore_torch.experiments.common import resolve_device, synchronize
from gpscore_torch.fit import make_objective
from gpscore_torch.parallel import (COLLECTIVES, gather_rows, init_distributed, make_mesh,
                                    make_sharded_fused_kfold_fit_step,
                                    make_sharded_fused_loo_fit_step,
                                    make_sharded_fused_nlml_fit_step, reset_collectives,
                                    shard_rows)
from gpscore_torch.utils.precision import MODES, matmul_mode

RULES = ("crps", "logs", "interval", "nlml", "dss", "es", "kc")
FOLD_RULES = ("dss", "es", "kc")
FOLD_K = 4  # make_sharded_fused_kfold_fit_step's default


def analytic_collective_bytes(n: int, d: int, block: int, p: int, rule: str,
                              storage_bytes: int, fold_k: int = FOLD_K) -> dict:
    """The output bytes a rank receives in the collectives of one fused
    sharded step (JAX's stage formulas, `bench_sharded.py:20-29`, at the
    port's message sizes), with e = ``storage_bytes``, k = n / block:

    - x gathered: 4 n d; a = K^-1 y gathered: 4 n;
    - Cholesky: per pivot kb the band [b, kb] (e) and the pivot block [b, b]
      (fp32): e n^2 / 2 - e n b / 2 + 4 k b^2;
    - triangular inverse: per panel the strip [n, b] (e): e n^2;
    - lauum: per panel B^T [b, n - s] (fp32): 2 n^2 + 2 n b;
    - a LOO rule: diag(K^-1) gathered 4 n; in the backward w gathered 4 n and
      per row block its columns [b, n/p] (fp32) reduce-scattered: 4 n^2 / p;
    - nlml: nothing but the O(d) sums;
    - a fold rule: per fold the block [nb, nb] (e) in the forward and again
      in the backward, and per fold and row block the strip [nb, b] (e):
      2 e n^2 / fold_k + e n^2; w gathered 4 n;
    - every backward: the O(d) sums all-reduced, 4 (d + 2).
    """
    b, k, e = block, n // block, storage_bytes
    total = 4 * n * d + 4 * n
    total += sum(e * b * kb + 4 * b * b for kb in range(0, n, b))
    total += k * e * n * b
    total += sum(4 * b * (n - s) for s in range(0, n, b))
    if rule in FOLD_RULES:
        nb = n // fold_k
        total += 2 * fold_k * e * nb * nb + fold_k * k * e * nb * b + 4 * n
    elif rule != "nlml":
        total += 4 * n + 4 * n + k * 4 * b * (n // p)
    total += 4 * (d + 2)
    return {"analytic_collective_bytes": total, "analytic_collective_gb": total / 1e9}


def make_step(mesh, rule: str, block: int, lr: float = 0.0, fold_k: int = FOLD_K,
              num_sim: int = 300):
    """The fused sharded step of ``rule`` (``fold_k`` and ``num_sim``: the
    k-fold rules')."""
    if rule == "nlml":
        return make_sharded_fused_nlml_fit_step(mesh, lr=lr, block=block)
    if rule in FOLD_RULES:
        return make_sharded_fused_kfold_fit_step(mesh, rule=rule, fold_k=fold_k, lr=lr,
                                                 block=block, num_sim=num_sim)
    return make_sharded_fused_loo_fit_step(mesh, lr=lr, block=block, rule=rule)


def _timed(fn, device) -> float:
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return time.perf_counter() - t0


def run(args, device) -> dict:
    """The measurement on every rank of the default group; the record, the
    same on every rank."""
    p = dist.get_world_size()
    mesh = make_mesh(devices=device, batch=1, data=p)
    x, y = (t.to(device) for t in bench_ceiling.make_data(args.n, args.d))
    x_loc = shard_rows(x, mesh)
    step = make_step(mesh, args.rule, args.block)

    def es_kw():  # the same normals on every rank and in every step
        return ({"generator": torch.Generator(device=device).manual_seed(7)}
                if args.rule == "es" else {})

    rec = {"rule": args.rule, "n": args.n, "d": args.d, "block": args.block,
           "matmul": args.matmul, "devices": p}
    t0 = time.perf_counter()
    loss, _ = step(bench_ceiling._params(0, args.d, device), x_loc, y, **es_kw())
    synchronize(device)
    rec.update(warmup_s=time.perf_counter() - t0, loss=float(loss))
    times = [_timed(lambda: step(bench_ceiling._params(i, args.d, device), x_loc, y, **es_kw()),
                    device) for i in range(1, args.repeats + 1)]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_collectives()
    step(bench_ceiling._params(0, args.d, device), x_loc, y, **es_kw())
    synchronize(device)
    collectives = {kind: dict(c) for kind, c in COLLECTIVES.items() if c["count"]}
    peak = compute = comm = 0.0
    kinds = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device) / (4.0 * args.n ** 2)
        busy, kinds, _, _ = bench_ceiling.device_profile(
            lambda: step(bench_ceiling._params(0, args.d, device), x_loc, y, **es_kw()))
        comm = kinds["collective"]
        compute = busy - comm
    ranks = gather_rows(torch.tensor([[min(times), peak, compute, comm]], dtype=torch.float64,
                                     device=device), mesh).tolist()
    rec.update(rank_step_s=[r[0] for r in ranks], step_s=max(r[0] for r in ranks),
               rank_peak_n2=[r[1] for r in ranks] if cuda else None,
               peak_n2=max(r[1] for r in ranks) if cuda else None,
               rank_compute_s=[r[2] for r in ranks] if cuda else None,
               rank_collective_s=[r[3] for r in ranks] if cuda else None,
               busy_by_kind=kinds, collectives=collectives)
    storage_bytes = 2 if args.matmul in ("bf16", "f16") else 4
    rec.update(analytic_collective_bytes(args.n, args.d, args.block, p, args.rule, storage_bytes))

    # bench_ceiling's single-device step on rank 0; the others wait in the gather.
    single = 0.0
    if mesh.index("data") == 0:
        loss = make_objective(args.rule, model="exact", block=args.block)
        vg = bench_ceiling.value_and_grad
        _timed(lambda: vg(loss, bench_ceiling._params(0, args.d, device), x, y, **es_kw()),
               device)
        single = min(_timed(lambda: vg(loss, bench_ceiling._params(i, args.d, device), x, y,
                                       **es_kw()), device) for i in range(1, args.repeats + 1))
    rec["single_step_s"] = gather_rows(torch.tensor([single], dtype=torch.float64,
                                                    device=device), mesh)[0].item()
    rec["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec["nvidia_smi"] = nvidia_smi_line() if device.type == "cuda" else None
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # --rows and --dims: the same flags under a torchrun whose own parser takes
    # --n and --d for abbreviations of its options (torch 2.11's does).
    ap.add_argument("--n", "--rows", dest="n", type=int, default=8192)
    ap.add_argument("--d", "--dims", dest="d", type=int, default=8)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--rule", default="crps", choices=list(RULES))
    ap.add_argument("--matmul", default="highest", choices=list(MODES),
                    help="precision mode of the steps (gpscore_torch.utils.precision)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    joined = not dist.is_initialized()
    device = init_distributed(resolve_device(args.device))
    try:
        with matmul_mode(args.matmul):
            rec = run(args, device)
        if dist.get_rank() == 0:
            print(json.dumps(rec, sort_keys=True), flush=True)
    finally:
        if joined:
            dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
