from gpscore_torch.scoring.rules import (
    crps_gaussian,
    crps_kfold,
    dss,
    dss_precision,
    energy_score,
    energy_score_core,
    energy_score_precision,
    interval_score,
    logs_gaussian,
)

__all__ = [
    "crps_gaussian",
    "crps_kfold",
    "dss",
    "dss_precision",
    "energy_score",
    "energy_score_core",
    "energy_score_precision",
    "interval_score",
    "logs_gaussian",
]
