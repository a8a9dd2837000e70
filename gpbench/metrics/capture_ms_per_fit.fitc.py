"""Host milliseconds of a five-rule fit's CUDA-graph captures (the program's
``fit.capture`` spans: capture and instantiation), per rule the mean over
its traced fits, summed over the rules. Read under the profiler."""

from gpbench.metrics._spans import fitc_host_ms_per_fit, log


def read(data):
    return fitc_host_ms_per_fit(data, log(), "fit.capture")
