"""Host milliseconds of a five-rule fit's eager steps (the program's
``fit.eager`` spans: the warm-up steps before each rule's capture), per rule
the mean over its traced fits, summed over the rules. Read under the
profiler, so it includes the profiler's host cost."""

from gpbench.metrics._spans import fitc_host_ms_per_fit, log


def read(data):
    return fitc_host_ms_per_fit(data, log(), "fit.eager")
