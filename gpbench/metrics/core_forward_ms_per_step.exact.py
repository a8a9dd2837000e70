"""Device milliseconds a step in the large-n core's forward (the program's
``core.forward`` spans: K_hat built, factored and inverted in place, a =
K^-1 y, the folds' statistics), over the traced fits' iterations."""

from gpbench.metrics._spans import exact_device_ms_per_step, log


def read(data):
    return exact_device_ms_per_step(data, log(), "core.forward")
