"""The d-chunked Gram calls' share of their roofline over the traced large-n
steps, in %: the trace data's bound of a step's d-chunked calls (the forward
over all of K_hat, both backward halves on each row block [r0, r1) against
the columns [0, r1), once a streamed pass; frozen ``gram_roofline``) times the
traced fits' iterations, over the device time of the program's chunked
``gram.*`` spans."""

from gpbench.metrics._gram_spans import dchunk_device_ms
from gpbench.metrics._spans import log


def read(data):
    got = dchunk_device_ms(data, log())
    if got is None or not data.get("dchunk_bound_us"):
        return None
    ms, steps = got
    return 100.0 * data["dchunk_bound_us"] * steps / (ms * 1e3) if ms > 0 else None
