"""Device milliseconds a step in the d-chunked Gram calls of the large-n step
(the program's ``gram.fwd`` and ``gram.bwd`` spans whose ``chunked`` is set:
the forward over all of K_hat and the backward's row blocks), over the
traced fits' iterations."""

from gpbench.metrics._gram_spans import dchunk_device_ms
from gpbench.metrics._spans import log


def read(data):
    got = dchunk_device_ms(data, log())
    if got is None:
        return None
    ms, steps = got
    return ms / steps
