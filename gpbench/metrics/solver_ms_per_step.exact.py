"""Device milliseconds a step in cuSOLVER and triangular-solve kernels of the
large-n cores."""

from gpbench.metrics._exact import kind_ms_per_step


def read(data):
    return kind_ms_per_step(data, "solver")
