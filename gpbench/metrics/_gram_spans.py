"""The program's Gram spans (``gram.fwd`` and ``gram.bwd``, one a call of the
Gram kernels' dispatchers, each with its ``chunked`` attribute) over the
traced large-n fits: the d-chunked calls' device time, normalized by the
``fit`` spans the log holds, as :mod:`gpbench.metrics._spans` does.

None where the trace data names no Gram spans a step (a driver that counts
none), where the program keeps no span log or the log dropped a span, where
it holds no ``fit`` span, where it does not hold the spans a step the trace
data names for every traced step (a program without Gram spans holds none),
where no span is chunked, or where a chunked span lacks device time."""

from gpbench.metrics._spans import _fits, _under


def dchunk_device_ms(data, spans):
    """(device ms of the chunked Gram spans, the traced fits' iterations), or
    None."""
    want = data.get("gram_spans_per_step") if data.get("kind") == "exact" else None
    if not want or spans is None or spans[1]:
        return None
    recs = spans[0]
    fits = _fits(recs)
    steps = sum(f.attrs["iters"] for f in fits)
    if not steps:
        return None
    grams = {name: _under(recs, name, fits) for name in want}
    if any(len(grams[name]) != per_step * steps for name, per_step in want.items()):
        return None
    chunked = [s for found in grams.values() for s in found if s.attrs.get("chunked")]
    if not chunked or any(s.device_ms is None for s in chunked):
        return None
    return sum(s.device_ms for s in chunked), steps
