"""Device milliseconds a step in the large-n core's backward (the program's
``core.backward`` spans: the streamed passes through the Gram backward
kernels, with the folds' cotangent solves), over the traced fits' iterations."""

from gpbench.metrics._spans import exact_device_ms_per_step, log


def read(data):
    return exact_device_ms_per_step(data, log(), "core.backward")
