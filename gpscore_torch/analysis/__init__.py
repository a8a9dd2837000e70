"""The analysis suite (port of `gpscore/analysis`): objective surfaces, scoring-rule
sensitivity curves, the CRPS illustration; figures in :mod:`.plots`."""

from gpscore_torch.analysis.surfaces import objective_surface, wrong_crps_objective
from gpscore_torch.analysis.sensitivity import (
    crps_mean_error_curve,
    crps_var_error_curve,
    logs_mean_error_curve,
    logs_var_error_curve,
    dss_mean_error_curve,
    dss_var_error_curve,
    es_mean_error_curve,
    es_var_error_curve,
    dss_correlation_curve,
    es_correlation_curve,
    dss_correlation_family,
    es_correlation_family,
)
from gpscore_torch.analysis.crps_illustration import CRPSCurves, crps_illustration

__all__ = [
    "objective_surface",
    "wrong_crps_objective",
    "crps_mean_error_curve",
    "crps_var_error_curve",
    "logs_mean_error_curve",
    "logs_var_error_curve",
    "dss_mean_error_curve",
    "dss_var_error_curve",
    "es_mean_error_curve",
    "es_var_error_curve",
    "dss_correlation_curve",
    "es_correlation_curve",
    "dss_correlation_family",
    "es_correlation_family",
    "CRPSCurves",
    "crps_illustration",
]
