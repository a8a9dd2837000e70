from gpscore_torch.models.exact import Gaussian
from gpscore_torch.models.fitc import (
    FITCTerms,
    LowRankPrecisionGaussian,
    fitc_half_logdet,
    fitc_predictive,
    fitc_terms,
    kfold_fitc_lowrank,
    loo_fitc,
    lowrank_fold_cov_diag,
    lowrank_fold_logdet_cov,
    lowrank_fold_quad,
    lowrank_fold_sample,
    nlml_fitc,
)

__all__ = [
    "Gaussian",
    "FITCTerms",
    "LowRankPrecisionGaussian",
    "fitc_half_logdet",
    "fitc_predictive",
    "fitc_terms",
    "kfold_fitc_lowrank",
    "loo_fitc",
    "lowrank_fold_cov_diag",
    "lowrank_fold_logdet_cov",
    "lowrank_fold_quad",
    "lowrank_fold_sample",
    "nlml_fitc",
]
