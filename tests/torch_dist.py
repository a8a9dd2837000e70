"""Spawned gloo ranks for the mesh tests of gpscore_torch.parallel.

The children import torch, numpy and gpscore_torch only (never JAX): the
test process computes the JAX side and hands the inputs over as numpy
arrays. A spawn rendezvouses through a ``file://`` store under the test's
``tmp_path`` (xdist runs several files at once: no fixed TCP port), each
collective has a timeout, and the spawn as a whole has a deadline after
which its processes are killed, so a hung collective fails its test and
not the suite.

Each case runs on one world of ranks and may build several meshes of it:
with 4 ranks, ('batch', 'data') = (4, 1), (2, 2) and (1, 4) put 1, 2 and 4
ranks on 'data'. A case returns a dict of numpy arrays, saved per rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 60


def meshes(world):
    """(batch, data) of every mesh a case builds: 1, 2 and 4 ranks on 'data'
    where the world divides by them."""
    return [(world // d, d) for d in (1, 2, 4) if world % d == 0]


def _np(t):
    return t.detach().cpu().numpy()


def _params(arrays):
    from gpscore_torch.utils.params import params_from_numpy

    return params_from_numpy(arrays)


def _grads(g):
    return {f: _np(t) for f, t in g.leaves().items()}


def case_mesh(world, x, lls, pb, y_sweep, x_sweep, iters, lr):
    """The sharded Gram (values and the all-reduced parameter gradient of
    sum(K * G)), the sharded restart sweep, and the dry run."""
    from gpscore_torch.fit import make_objective
    from gpscore_torch.parallel import (gather_rows, make_mesh, shard_rows, sharded_gram,
                                        sharded_restart_sweep)
    from gpscore_torch.ops.kernels import gram
    from gpscore_torch.parallel import restart_sweep
    from gpscore_torch.parallel.dryrun import dryrun_multichip
    from gpscore_torch.parallel.mesh import all_reduce_sum

    out = {}
    xt = torch.as_tensor(x)
    G = torch.as_tensor(np.cos(np.arange(x.shape[0] ** 2, dtype=np.float32)).reshape(
        x.shape[0], x.shape[0]))
    for b, d in meshes(world):
        mesh = make_mesh(batch=b, data=d)
        out[f"coords_{b}x{d}"] = np.asarray([mesh.index("batch"), mesh.index("data"),
                                             mesh.global_rank("data", 0),
                                             mesh.global_rank("batch", 0)])
        sig = torch.tensor(0.2, requires_grad=True)
        ll = torch.as_tensor(lls).clone().requires_grad_()
        K = sharded_gram(shard_rows(xt, mesh), sig, ll, mesh)
        gs = torch.autograd.grad(torch.sum(K * shard_rows(G, mesh)), [sig, ll])
        for g in gs:
            all_reduce_sum(g, mesh)
        out[f"gram_{d}"] = _np(gather_rows(K.detach(), mesh))
        out[f"gram_grad_sig_{d}"], out[f"gram_grad_ll_{d}"] = map(_np, gs)
        res = sharded_restart_sweep(make_objective("crps", model="exact"), _params(pb),
                                    torch.as_tensor(x_sweep), torch.as_tensor(y_sweep),
                                    iters=iters, lr=lr, mesh=mesh)
        out[f"sweep_loss_{b}"] = _np(res.loss_history)
        for f, t in res.params.leaves().items():
            out[f"sweep_{f}_{b}"] = _np(t)
    # The unsharded port in the same process (its thread settings), for the
    # bitwise checks at one rank on an axis.
    out["gram_unsharded"] = _np(gram(xt, xt, 0.2, torch.as_tensor(lls)))
    res = restart_sweep(make_objective("crps", model="exact"), _params(pb),
                        torch.as_tensor(x_sweep), torch.as_tensor(y_sweep), iters=iters, lr=lr)
    out["sweep_loss_unsharded"] = _np(res.loss_history)
    dry = dryrun_multichip("cpu")
    out["dry_sweep"] = np.asarray(dry["sweep_losses"])
    out["dry_steps"] = np.asarray(dry["loo_step"] + dry["kfold_step"])
    return out


def case_dryrun(world):
    """dryrun_multichip on the ranks."""
    from gpscore_torch.parallel.dryrun import dryrun_multichip

    dry = dryrun_multichip("cpu")
    return {"cholesky_rows": np.asarray(dry["cholesky_rows"]),
            "steps": np.asarray(dry["loo_step"] + dry["kfold_step"]),
            **{k: np.asarray(v) for k, v in dry.items() if k.startswith(("fused_", "f16_"))}}


def case_multi_restart(world, out_path, iters, restarts):
    """multi_restart.main on the ranks, its schedules cut to ``iters``."""
    from gpscore_torch.experiments import multi_restart
    from gpscore_torch.fit.schedules import SCHEDULES

    multi_restart.SCHEDULES = {k: dataclasses.replace(s, iters=iters)
                               for k, s in SCHEDULES.items()}
    res = multi_restart.main(["--device", "cpu", "--restarts", str(restarts),
                              "--rules", "crps", "nlml", "--out", out_path])
    return {f"{tag}/{k}": np.asarray(v) for tag, rec in res.items() for k, v in rec.items()}


def case_dense(world, A, b, x, y, K, p, lr, block, fold_k):
    """The Cholesky family, the LOO moments, the two solve cores with their
    gradients, every exact rule's value and gradient, FITC, the two fit
    steps and the shape checks, at 1, 2 and 4 ranks on 'data'."""
    from gpscore_torch.parallel import (gather_rows, make_mesh, make_sharded_kfold_blocks,
                                        make_sharded_kfold_fit_step, make_sharded_loo_fit_step,
                                        make_sharded_loo_solve_diag, shard_rows,
                                        sharded_cholesky, sharded_half_logdet,
                                        sharded_loo_moments, sharded_loo_value_and_grad,
                                        sharded_nlml, sharded_tri_solve_lower)

    out = {}
    At, bt, xt, yt, Kt = map(torch.as_tensor, (A, b, x, y, K))
    params = _params(p)
    for _, d in meshes(world):
        mesh = make_mesh(batch=world // d, data=d)
        L = sharded_cholesky(shard_rows(At, mesh), mesh, block=block)
        out[f"chol_{d}"] = _np(gather_rows(L, mesh))
        out[f"half_logdet_{d}"] = _np(sharded_half_logdet(L, mesh))
        out[f"tri_solve_{d}"] = _np(sharded_tri_solve_lower(L, bt, mesh, block=block))
        out[f"nlml_{d}"] = _np(sharded_nlml(shard_rows(Kt, mesh), yt, 0.25, mesh, block=block))
        mean, var = sharded_loo_moments(shard_rows(Kt, mesh), yt, 0.25, mesh, block=block)
        out[f"moments_{d}"] = _np(torch.stack([mean, var]))

        # The two solve cores: value and the gradient in K of the JAX tests'
        # objectives, sum(sin(a) / d) and sum(sin(a)) + sum(cos(A)).
        Kl = shard_rows(At, mesh).clone().requires_grad_()
        a_, d_ = make_sharded_loo_solve_diag(mesh, block=block)(Kl, bt)
        v = torch.sum(torch.sin(a_) / d_)
        out[f"solve_diag_{d}"] = _np(v)
        out[f"solve_diag_grad_{d}"] = _np(gather_rows(torch.autograd.grad(v, Kl)[0], mesh))
        Kl = shard_rows(At, mesh).clone().requires_grad_()
        a_, A_ = make_sharded_kfold_blocks(mesh, fold_k, block=block)(Kl, bt)
        v = torch.sum(torch.sin(a_)) + torch.sum(torch.cos(A_))
        out[f"kfold_blocks_{d}"] = _np(v)
        out[f"kfold_blocks_grad_{d}"] = _np(gather_rows(torch.autograd.grad(v, Kl)[0], mesh))

        x_loc = shard_rows(xt, mesh)
        for rule in ("crps", "logs", "interval", "nlml", "dss", "kc"):
            val, g = sharded_loo_value_and_grad(params, x_loc, yt, mesh, rule=rule, block=block)
            out[f"vg_{rule}_{d}"] = _np(val)
            for f, t in _grads(g).items():
                out[f"vg_{rule}_{f}_{d}"] = t
        val, g = sharded_loo_value_and_grad(params, x_loc, yt, mesh, rule="es", block=block,
                                            generator=torch.Generator().manual_seed(0))
        out[f"vg_es_finite_{d}"] = np.asarray(
            bool(torch.isfinite(val)) and all(np.isfinite(v).all() for v in _grads(g).values()))
        try:
            sharded_loo_value_and_grad(params, x_loc, yt, mesh, rule="es")
            out[f"es_needs_generator_{d}"] = np.asarray(False)
        except ValueError as e:
            out[f"es_needs_generator_{d}"] = np.asarray("generator" in str(e))
        fitc = params.replace(inducing=torch.as_tensor(x[:5]).clone())
        val, g = sharded_loo_value_and_grad(fitc, x_loc, yt, mesh, rule="crps", model="fitc")
        out[f"fitc_{d}"] = _np(val)
        for f, t in _grads(g).items():
            out[f"fitc_{f}_{d}"] = t

        loss0, p1 = make_sharded_loo_fit_step(mesh, lr=lr, block=block)(params, x_loc, yt)
        out[f"loo_step_{d}"] = _np(loss0)
        for f, t in p1.leaves().items():
            out[f"loo_step_{f}_{d}"] = _np(t)
        for rule in ("dss", "kc"):
            step = make_sharded_kfold_fit_step(mesh, rule=rule, fold_k=fold_k, lr=lr, block=block)
            loss0, p1 = step(params, x_loc, yt)
            loss1, _ = step(p1, x_loc, yt)
            out[f"kfold_step_{rule}_{d}"] = _np(torch.stack([loss0, loss1]))
            for f, t in p1.leaves().items():
                out[f"kfold_step_{rule}_{f}_{d}"] = _np(t)

        bad = []
        eye = torch.eye(24 * d)  # 24 rows a rank: no panel of 16 fits
        for fn in (lambda: sharded_cholesky(shard_rows(eye, mesh), mesh, block=16),
                   lambda: sharded_tri_solve_lower(shard_rows(eye, mesh), torch.zeros(24 * d),
                                                   mesh, block=16),
                   lambda: make_sharded_kfold_blocks(mesh, 5, block=block)(
                       shard_rows(At, mesh), bt),
                   lambda: make_mesh(batch=3, data=d)):
            try:
                fn()
                bad.append(False)
            except ValueError:
                bad.append(True)
        out[f"bad_shapes_{d}"] = np.asarray(bad)
    return out


def case_fused(world, x, y, p, cot, lr, block, num_sim, eps4, eps2):
    """The in-place sharded K_hat^-1 (fp32, bf16, f16), sharded_diag, the
    streamed backward in its three modes, the fused LOO, NLML and
    fold-streamed k-fold steps (both contraction orders; es at the given
    normals; f16 crps and dss), the collectives a step issued and the shape
    checks, at 1, 2 and 4 ranks on 'data'. ``cot``: the cotangents of the
    backward's modes; ``eps4``/``eps2``: the es normals at fold_k = 4 and 2."""
    from gpscore_torch.experiments.bench_sharded import analytic_collective_bytes
    from gpscore_torch.ops.potri_inplace import ard_gram_inverse_inplace
    from gpscore_torch.parallel import (COLLECTIVES, ard_gram_inverse_inplace_sharded,
                                        gather_rows, make_mesh, make_sharded_fused_kfold_fit_step,
                                        make_sharded_fused_loo_fit_step,
                                        make_sharded_fused_nlml_fit_step,
                                        make_sharded_streamed_kfold_fit_step,
                                        make_streamed_ard_bwd, reset_collectives, shard_rows,
                                        sharded_diag)
    from gpscore_torch.utils.precision import matmul_mode

    out = {}
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    params = _params(p)
    s, ell, nu = params.log_signal_sq, params.log_length, params.log_noise_sq
    n = x.shape[0]
    # The unsharded pipeline in this process (its thread settings), for the
    # bitwise checks at one rank on 'data'.
    for name, st in (("fp32", None), ("bf16", torch.bfloat16), ("f16", torch.float16)):
        out[f"potri_unsharded_{name}"] = _np(ard_gram_inverse_inplace(
            s, ell, nu, xt, block=block, storage=st).float())
    for _, d in meshes(world):
        mesh = make_mesh(batch=world // d, data=d)
        x_loc = shard_rows(xt, mesh)
        for name, st in (("fp32", None), ("bf16", torch.bfloat16), ("f16", torch.float16)):
            Kinv, hld = ard_gram_inverse_inplace_sharded(s, ell, nu, xt, mesh, block=block,
                                                         storage=st)
            out[f"potri_{name}_{d}"] = _np(gather_rows(Kinv.float(), mesh))
            out[f"potri_hld_{name}_{d}"] = _np(hld)
        Kinv, _ = ard_gram_inverse_inplace_sharded(s, ell, nu, xt, mesh, block=block)
        out[f"diag_{d}"] = _np(gather_rows(sharded_diag(Kinv, mesh), mesh))
        a = gather_rows(Kinv @ yt, mesh)
        cases = [("loo", None, (torch.as_tensor(cot["a_bar"]), torch.as_tensor(cot["d_bar"]))),
                 ("nlml", None, torch.tensor(float(cot["v_bar"]))),
                 ("kfold", 4, (torch.as_tensor(cot["a_bar"]), torch.as_tensor(cot["A_bar4"])))]
        if d == 4:
            cases.append(("kfold", 2, (torch.as_tensor(cot["a_bar"]),
                                       torch.as_tensor(cot["A_bar2"]))))
        for mode, fk, c in cases:
            bwd = make_streamed_ard_bwd(mesh, mode, fold_k=fk, block=block)
            got = bwd(Kinv, a, xt, s, ell, nu, c)
            for i, t in enumerate(got):
                out[f"bwd_{mode}{fk or ''}_{i}_{d}"] = _np(t)

        def record(key, step, **kw):  # the loss and the updated parameters of one step
            loss, p1 = step(params, x_loc, yt, **kw)
            out[f"{key}_{d}"] = _np(loss)
            for f, t in p1.leaves().items():
                out[f"{key}_{f}_{d}"] = _np(t)

        for rule in ("crps", "logs", "interval"):
            record(f"loo_{rule}", make_sharded_fused_loo_fit_step(mesh, lr=lr, block=block,
                                                                  rule=rule))
        record("nlml", make_sharded_fused_nlml_fit_step(mesh, lr=lr, block=block))
        for fk in (4, 2) if d == 4 else (4,):
            for rule in ("dss", "kc"):
                record(f"kfold_{rule}{fk}", make_sharded_fused_kfold_fit_step(
                    mesh, rule=rule, fold_k=fk, lr=lr, block=block))
            record(f"kfold_es{fk}", make_sharded_streamed_kfold_fit_step(
                mesh, rule="es", fold_k=fk, lr=lr, block=block, num_sim=num_sim),
                eps=torch.as_tensor(eps4 if fk == 4 else eps2))
        with matmul_mode("f16"):
            record("f16_crps", make_sharded_fused_loo_fit_step(mesh, lr=lr, block=block))
            record("f16_dss", make_sharded_fused_kfold_fit_step(mesh, rule="dss", lr=lr,
                                                                block=block))

        # The collectives of one step against the analytic count, per rule.
        counted = {}
        for rule, step in (("crps", make_sharded_fused_loo_fit_step(mesh, lr=lr, block=block)),
                           ("nlml", make_sharded_fused_nlml_fit_step(mesh, lr=lr, block=block)),
                           ("dss", make_sharded_fused_kfold_fit_step(mesh, lr=lr,
                                                                     block=block))):
            reset_collectives()
            step(params, x_loc, yt)
            got = sum(c["bytes"] for c in COLLECTIVES.values())
            want = analytic_collective_bytes(n, x.shape[1], block, d, rule, 4)
            counted[rule] = got == want["analytic_collective_bytes"]
        out[f"collectives_{d}"] = np.asarray([counted[r] for r in ("crps", "nlml", "dss")])

        # n = 128 not divisible by p * 24; fold_k = 3 not dividing n; folds of
        # 42 rows, which do not tile a rank's rows.
        bad = []
        for fn in (lambda: make_sharded_fused_loo_fit_step(mesh, block=3 * block)(
                       params, x_loc, yt),
                   lambda: ard_gram_inverse_inplace_sharded(s, ell, nu, xt, mesh,
                                                            block=3 * block),
                   lambda: make_sharded_fused_kfold_fit_step(mesh, fold_k=3, block=block)(
                       params, x_loc, yt),
                   lambda: make_streamed_ard_bwd(mesh, "kfold", fold_k=3, block=block)(
                       Kinv, a, xt, s, ell, nu, (a, torch.zeros(3, 42, 42)))):
            try:
                fn()
                bad.append(False)
            except ValueError:
                bad.append(True)
        try:
            make_sharded_fused_kfold_fit_step(mesh, streamed=False)
            bad.append(False)
        except NotImplementedError as e:
            bad.append("Not to port" in str(e))
        out[f"bad_shapes_{d}"] = np.asarray(bad)
    return out


def case_bench_sharded(world, argv):
    """bench_sharded.main on the ranks: its record as JSON."""
    import json

    from gpscore_torch.experiments import bench_sharded

    return {"record": np.asarray(json.dumps(bench_sharded.main(argv)))}


CASES = {"mesh": case_mesh, "multi_restart": case_multi_restart, "dense": case_dense,
         "dryrun": case_dryrun, "fused": case_fused, "bench_sharded": case_bench_sharded}


def _child(rank, world, store, out_dir, case, kwargs):
    try:
        # One intra-op thread a rank: four ranks of the default thread count
        # on a few cores made every gloo collective ~35 ms slower.
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        out = CASES[case](world, **kwargs)
        np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **out)
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"{case}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(case, world, tmp_path, timeout=240, **kwargs):
    """Run ``case`` on ``world`` spawned gloo ranks; return each rank's dict
    of arrays. Raises (with the children's tracebacks) on a failure, and
    kills the ranks past ``timeout`` seconds."""
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, f"store_{case}_{world}")
    ctx = mp.start_processes(_child, args=(world, store, out_dir, case, kwargs), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{case} on {world} ranks: not done in {timeout} s")
    except BaseException as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                if f.endswith(".err")]
        raise RuntimeError("\n".join(errs) or str(e)) from e
    return [dict(np.load(os.path.join(out_dir, f"{case}_{r}.npz"))) for r in range(world)]
