from gpscore_torch.scoring.rules import (
    crps_gaussian,
    crps_kfold,
    energy_score_core,
    interval_score,
    logs_gaussian,
)

__all__ = [
    "crps_gaussian",
    "crps_kfold",
    "energy_score_core",
    "interval_score",
    "logs_gaussian",
]
