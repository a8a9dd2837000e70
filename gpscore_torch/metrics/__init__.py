from gpscore_torch.metrics.evaluation import (
    EvalMetrics,
    coverage95,
    evaluate_predictive,
    mse,
    msll,
    smse,
)

__all__ = ["EvalMetrics", "coverage95", "evaluate_predictive", "mse", "msll", "smse"]
