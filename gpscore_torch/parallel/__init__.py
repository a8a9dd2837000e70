"""Sweeps over restarts and replicates, the device mesh, the distributed
dense stack, the in-place sharded K_hat^-1 with the fused sharded LOO, NLML
and k-fold steps on it, and the fold-streamed sharded k-fold (port of
`gpscore/parallel/`; every collective written out over
``torch.distributed``, NCCL on cards and gloo on the CPU).
"""

from gpscore_torch.parallel.mesh import (COLLECTIVES, batch_sharding, gather_rows,
                                         init_distributed, make_mesh, replicated,
                                         reset_collectives, shard_rows)
from gpscore_torch.parallel.sharded_cholesky import (add_noise_sharded, sharded_cholesky,
                                                     sharded_half_logdet, sharded_nlml,
                                                     sharded_tri_solve_lower)
from gpscore_torch.parallel.sharded_gram import sharded_gram
from gpscore_torch.parallel.sharded_potri import (ard_gram_inverse_inplace_sharded,
                                                  make_streamed_ard_bwd, sharded_diag)
from gpscore_torch.parallel.sharded_fold_stream import (make_sharded_streamed_fold_es,
                                                        make_sharded_streamed_fold_stats,
                                                        make_sharded_streamed_kfold_fit_step)
from gpscore_torch.parallel.sharded_kfold import (KFOLD_RULES, make_sharded_fused_kfold_fit_step,
                                                  make_sharded_kfold_blocks,
                                                  make_sharded_kfold_fit_step)
from gpscore_torch.parallel.sharded_loo import (make_sharded_fused_loo_fit_step,
                                                make_sharded_fused_nlml_fit_step,
                                                make_sharded_loo_fit_step,
                                                make_sharded_loo_solve_diag,
                                                sharded_loo_fit_step, sharded_loo_moments,
                                                sharded_loo_value_and_grad)
from gpscore_torch.parallel.sweeps import (default_sweep_generator, restart_sweep,
                                           sharded_restart_sweep)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "init_distributed",
    "shard_rows",
    "gather_rows",
    "COLLECTIVES",
    "reset_collectives",
    "sharded_gram",
    "ard_gram_inverse_inplace_sharded",
    "sharded_diag",
    "make_streamed_ard_bwd",
    "sharded_cholesky",
    "add_noise_sharded",
    "sharded_half_logdet",
    "sharded_nlml",
    "sharded_tri_solve_lower",
    "KFOLD_RULES",
    "make_sharded_fused_kfold_fit_step",
    "make_sharded_kfold_blocks",
    "make_sharded_kfold_fit_step",
    "make_sharded_streamed_fold_es",
    "make_sharded_streamed_fold_stats",
    "make_sharded_streamed_kfold_fit_step",
    "make_sharded_fused_loo_fit_step",
    "make_sharded_fused_nlml_fit_step",
    "make_sharded_loo_fit_step",
    "make_sharded_loo_solve_diag",
    "sharded_loo_fit_step",
    "sharded_loo_moments",
    "sharded_loo_value_and_grad",
    "default_sweep_generator",
    "restart_sweep",
    "sharded_restart_sweep",
]
