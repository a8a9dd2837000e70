from gpscore_torch.utils.checkpoint import load_metrics, load_pytree, save_metrics, save_pytree
from gpscore_torch.utils.params import (
    GPParams,
    batch_size,
    init_rand_params,
    init_unit_params,
    params_from_checkpoint,
    params_from_numpy,
    params_to_numpy,
    save_params_checkpoint,
    select_params,
    stack_params,
)
from gpscore_torch.utils.precision import (
    get_matmul_mode,
    matmul,
    matmul_crit,
    set_matmul_mode,
)
from gpscore_torch.utils.profiling import trace

__all__ = [
    "load_metrics",
    "load_pytree",
    "save_metrics",
    "save_pytree",
    "GPParams",
    "batch_size",
    "init_rand_params",
    "init_unit_params",
    "params_from_checkpoint",
    "params_from_numpy",
    "params_to_numpy",
    "save_params_checkpoint",
    "select_params",
    "stack_params",
    "get_matmul_mode",
    "set_matmul_mode",
    "matmul",
    "matmul_crit",
    "trace",
]
