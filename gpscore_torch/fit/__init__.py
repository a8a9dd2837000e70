from gpscore_torch.fit.driver import eval_predictive_metrics, fit_and_eval, fit_and_eval_batch
from gpscore_torch.fit.objectives import OBJECTIVE_RULES, make_objective
from gpscore_torch.fit.schedules import SCHEDULES, Schedule, get_schedule, rules_for
from gpscore_torch.fit.train import (FitResult, auto_recover_mode, fit_gd, fit_gd_batch,
                                     fit_gd_recovering, fit_optim, max_reduce, objective_family)

__all__ = [
    "eval_predictive_metrics",
    "fit_and_eval",
    "fit_and_eval_batch",
    "OBJECTIVE_RULES",
    "make_objective",
    "SCHEDULES",
    "Schedule",
    "get_schedule",
    "rules_for",
    "FitResult",
    "fit_gd",
    "fit_gd_batch",
    "fit_gd_recovering",
    "auto_recover_mode",
    "objective_family",
    "fit_optim",
    "max_reduce",
]
