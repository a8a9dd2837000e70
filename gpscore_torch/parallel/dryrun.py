"""One run of each leg of the multi-device dry run (port of
`__graft_entry__.py:103-252`, legs (1) to (12) of ``dryrun_multichip``).

Under ``torchrun`` every rank runs every leg; alone, the legs run on a mesh
of one rank. The mesh takes 'data' = 2 when the world size is even, the
rest on 'batch', as JAX's does; the Cholesky and the sharded steps take
every rank on 'data'. Legs (7)-(12) are the fused sharded steps, each built
once, run twice and held to descend, as in JAX: LOO crps, fold-streamed
k-fold dss, NLML, es at the normals of one fixed generator seed in both
steps, and the crps and dss steps under "f16" storage. The problems are
the JAX legs' sizes (x [32, 2], four inducing points, an 8 p x 8 p SPD
matrix, block 8), drawn from seeded CPU generators (not JAX's threefry
numbers) and moved to the mesh's device, the same on every rank.

    torchrun --nproc_per_node=2 -m gpscore_torch.parallel.dryrun --device cpu
    python -m gpscore_torch.parallel.dryrun            # one rank, on the card
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from gpscore_torch.fit import make_objective
from gpscore_torch.parallel.mesh import init_distributed, make_mesh, shard_rows
from gpscore_torch.parallel.sharded_cholesky import sharded_cholesky
from gpscore_torch.parallel.sharded_gram import sharded_gram
from gpscore_torch.parallel.sharded_kfold import (make_sharded_fused_kfold_fit_step,
                                                  make_sharded_kfold_fit_step)
from gpscore_torch.parallel.sharded_loo import (make_sharded_fused_loo_fit_step,
                                                make_sharded_fused_nlml_fit_step,
                                                make_sharded_loo_fit_step,
                                                sharded_loo_value_and_grad)
from gpscore_torch.parallel.sweeps import sharded_restart_sweep
from gpscore_torch.utils.params import GPParams, init_unit_params
from gpscore_torch.utils.precision import matmul_mode


def _tiny_problem(n=32, d=2, m=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    y = torch.sin(x.sum(dim=1)) + 0.1 * torch.randn(n, generator=g)
    u = torch.randn((m, d), generator=g)
    return x, y, u


def _to(p: GPParams, device) -> GPParams:
    return p.replace(**{f: t.to(device) for f, t in p.leaves().items()})


def _twice(step, p, x, y, **kw):
    """Two losses of ``step`` built once: from ``p``, then from its update;
    the second must be the lower."""
    loss, p1 = step(p, x, y, **kw)
    loss2, _ = step(p1, x, y, **kw)
    assert float(loss2) < float(loss), (float(loss), float(loss2))
    return float(loss), float(loss2)


def dryrun_multichip(device=None) -> dict:
    """Run legs (1)-(12) once on the mesh of every rank of the default group
    (joined if needed, :func:`init_distributed` on ``device``); returns each
    leg's result, the same on every rank."""
    device = init_distributed(device)
    world = dist.get_world_size()
    data_ax = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(devices=device, batch=world // data_ax, data=data_ax)
    mesh_d = mesh if data_ax == world else make_mesh(devices=device, batch=1, data=world)
    x, y, u = (t.to(device) for t in _tiny_problem(n=32, d=2, m=4))
    out = {}

    # (1) the 'data'-sharded Gram: all-gather of x, this rank's rows.
    K = sharded_gram(shard_rows(x, mesh), torch.tensor(0.1, device=device),
                     torch.zeros(2, device=device), mesh)
    assert K.shape == (32 // data_ax, 32)
    out["gram_rows"] = tuple(K.shape)

    # (2) the 'batch'-sharded restart sweep: one FITC crps step per restart.
    R = world
    g = torch.Generator().manual_seed(1)
    pb = GPParams(log_signal_sq=torch.ones(R), log_length=torch.rand((R, 2), generator=g),
                  log_noise_sq=torch.ones(R), inducing=u.cpu().expand(R, *u.shape).contiguous())
    res = sharded_restart_sweep(make_objective("crps", model="fitc"), _to(pb, device), x, y,
                                iters=1, lr=0.1, mesh=mesh)
    assert res.loss_history.shape == (R, 1)
    out["sweep_losses"] = res.loss_history[:, 0].tolist()

    # (3) the row-sharded dense LOO objective's value and gradient.
    p1 = _to(init_unit_params(d=2, isotropic=False), device)
    v, grads = sharded_loo_value_and_grad(p1, shard_rows(x, mesh), y, mesh, rule="crps")
    assert torch.isfinite(v) and all(torch.isfinite(t).all() for t in grads.leaves().values())
    out["loo_value"] = float(v)

    # (4) the panel Cholesky over every rank on 'data'.
    nn = 8 * world
    z = torch.randn((nn, nn), generator=torch.Generator().manual_seed(2))
    spd = (z @ z.T / nn + 3.0 * torch.eye(nn)).to(device)
    L = sharded_cholesky(shard_rows(spd, mesh_d), mesh_d, block=8)
    assert L.shape == (nn // world, nn)
    out["cholesky_rows"] = tuple(L.shape)

    # (5) the distributed-gradient LOO step, built once and run twice.
    gb = torch.Generator().manual_seed(3)
    xb = torch.randn((nn, 2), generator=gb).to(device)
    yb = torch.sin(xb.sum(dim=1))
    p2 = _to(init_unit_params(d=2, isotropic=False), device)
    step = make_sharded_loo_fit_step(mesh_d, lr=0.1, block=8)
    loss, p3 = step(p2, shard_rows(xb, mesh_d), yb)
    loss2, _ = step(p3, shard_rows(xb, mesh_d), yb)
    out["loo_step"] = (float(loss), float(loss2))

    # (6) the distributed k-fold dss step, twice.
    kstep = make_sharded_kfold_fit_step(mesh_d, rule="dss", fold_k=4, lr=0.001, block=8)
    kloss, p4 = kstep(p2, shard_rows(xb, mesh_d), yb)
    kloss2, _ = kstep(p4, shard_rows(xb, mesh_d), yb)
    out["kfold_step"] = (float(kloss), float(kloss2))
    assert all(map(torch.isfinite, (loss, loss2, kloss, kloss2)))

    # (7)-(9) the fused sharded LOO, fold-streamed k-fold dss and NLML steps.
    xd = shard_rows(xb, mesh_d)
    out["fused_loo_step"] = _twice(make_sharded_fused_loo_fit_step(mesh_d, lr=0.1, block=8), p2,
                                   xd, yb)
    out["fused_kfold_step"] = _twice(make_sharded_fused_kfold_fit_step(
        mesh_d, rule="dss", fold_k=4, lr=0.001, block=8), p2, xd, yb)
    out["fused_nlml_step"] = _twice(make_sharded_fused_nlml_fit_step(mesh_d, lr=0.001, block=8),
                                    p2, xd, yb)
    # (10) es: a generator of one seed in both steps, the same normals twice.
    estep = make_sharded_fused_kfold_fit_step(mesh_d, rule="es", fold_k=4, lr=0.01, block=8,
                                              num_sim=16)
    loss, p8 = estep(p2, xd, yb, generator=torch.Generator(device=device).manual_seed(5))
    loss2, _ = estep(p8, xd, yb, generator=torch.Generator(device=device).manual_seed(5))
    assert float(loss2) < float(loss), (float(loss), float(loss2))
    out["fused_es_step"] = (float(loss), float(loss2))
    # (11), (12) the LOO and the fold-streamed dss step under 2-byte storage.
    with matmul_mode("f16"):
        out["f16_loo_step"] = _twice(make_sharded_fused_loo_fit_step(mesh_d, lr=0.1, block=8),
                                     p2, xd, yb)
        out["f16_kfold_step"] = _twice(make_sharded_fused_kfold_fit_step(
            mesh_d, rule="dss", fold_k=4, lr=0.001, block=8), p2, xd, yb)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.device)
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok on {dist.get_world_size()} ranks: {out}", flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
