"""Per-objective training schedules (copy of `gpscore/fit/schedules.py`).

Copied rather than imported: importing ``gpscore`` pulls in JAX. The tests
hold this table equal to the JAX package's. Keys: (experiment, rule).

Experiments:
- ``simple_full``  `SIMPLE-DATA FULL-comapre.py`
- ``simple_fitc``  `SIMPLE-FITC--comapre.py`
- ``kin40k_full``  `kin40k-FULL-compare.py`
- ``kin40k_fitc``  `KIN40K-COMPARE-ALL-FITC-20.py`
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Schedule:
    rule: str
    iters: int
    lr: float
    lr_inducing: Optional[float] = None  # None -> same as lr


SCHEDULES = {
    # SIMPLE-DATA FULL-comapre.py:192,205 / :277,290 / :372,383
    ("simple_full", "crps"): Schedule("crps", 250, 1.0),
    ("simple_full", "nlml"): Schedule("nlml", 250, 0.001),
    ("simple_full", "logs"): Schedule("logs", 400, 0.05),
    # SIMPLE-FITC--comapre.py:189,205 / :301,318-319 / :420,437-438
    ("simple_fitc", "crps"): Schedule("crps", 1000, 1.0, 1.0),
    ("simple_fitc", "nlml"): Schedule("nlml", 1200, 0.0005, 0.005),
    ("simple_fitc", "logs"): Schedule("logs", 2500, 0.005, 0.005),
    # kin40k-FULL-compare.py:220,238 / :312,328 / :405,415 / :487,498 / :607,617
    ("kin40k_full", "crps"): Schedule("crps", 400, 1.0),
    ("kin40k_full", "nlml"): Schedule("nlml", 400, 0.0005),
    ("kin40k_full", "logs"): Schedule("logs", 500, 0.05),
    ("kin40k_full", "dss"): Schedule("dss", 150, 0.001),
    ("kin40k_full", "es"): Schedule("es", 25, 0.1),
    # KIN40K-COMPARE-ALL-FITC-20.py:207,220 / :315,326-327 / :417,430-431 /
    # :523,537 / :655,668
    ("kin40k_fitc", "crps"): Schedule("crps", 2000, 1.0, 1.0),
    ("kin40k_fitc", "nlml"): Schedule("nlml", 3000, 0.0001, 0.001),
    ("kin40k_fitc", "logs"): Schedule("logs", 3000, 0.2, 0.2),
    ("kin40k_fitc", "dss"): Schedule("dss", 3000, 0.001, 0.001),
    ("kin40k_fitc", "kc"): Schedule("kc", 3000, 0.1, 0.1),
    # Interval score: a framework addition with no reference schedule; CRPS's
    # iteration counts at a tenth of its lr (see the JAX package's table).
    ("simple_full", "interval"): Schedule("interval", 250, 0.1),
    ("kin40k_full", "interval"): Schedule("interval", 400, 0.1),
    ("kin40k_fitc", "interval"): Schedule("interval", 2000, 0.1, 0.1),
}


def rules_for(experiment: str) -> list:
    """Rules with a reference schedule for ``experiment``."""
    return [r for (e, r) in SCHEDULES if e == experiment]


def get_schedule(experiment: str, rule: str) -> Schedule:
    try:
        return SCHEDULES[(experiment, rule)]
    except KeyError:
        raise KeyError(
            f"no reference schedule for ({experiment!r}, {rule!r}); "
            f"available: {sorted(SCHEDULES)}"
        ) from None
