"""Reductions of the program's own spans (``gpscore_torch.utils.profiling``'s
log), which hold the trace phase's spans when a reader runs: the GD loop's
``fit``, ``fit.eager`` and ``fit.capture``, and the large-n cores'
``core.forward`` and ``core.backward``. Each reduction normalizes by the
``fit`` spans the log holds, so a retaken traced call counts as one more
call. It returns None where the program keeps no span log, where the log
dropped a span, where it holds no ``fit`` span, or where a span it reads
lacks device time."""


def log():
    """(spans, dropped) of the program's log, or None where it keeps none."""
    try:
        from gpscore_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def _host_ms(s):
    return (s.end_ns - s.start_ns) / 1e6


def _fits(recs):
    return [s for s in recs if s.name == "fit"]


def _rule_fits(data, recs):
    """{rule: its fit spans}, a rule's fits those of its objective
    (``<rule>_fitc_objective``), or None where a rule has none."""
    out = {}
    for rule in data["rules"]:
        fits = [s for s in _fits(recs)
                if str(s.attrs.get("objective", "")).startswith(f"{rule}_")]
        if not fits:
            return None
        out[rule] = fits
    return out


def _under(recs, name, fits):
    ids = {f.id for f in fits}
    return [s for s in recs if s.name == name and s.root in ids]


def fitc_host_ms_per_fit(data, spans, name):
    """Host ms of the ``name`` spans a fit: per rule the mean over its traced
    fits, summed over the cell's rules."""
    if data.get("kind") != "fitc" or spans is None or spans[1]:
        return None
    recs = spans[0]
    by_rule = _rule_fits(data, recs)
    if by_rule is None:
        return None
    return sum(sum(_host_ms(s) for s in _under(recs, name, fits)) / len(fits)
               for fits in by_rule.values())


def exact_device_ms_per_step(data, spans, name):
    """Device ms of the ``name`` spans over the iterations of the traced fits."""
    if data.get("kind") != "exact" or spans is None or spans[1]:
        return None
    recs = spans[0]
    fits = _fits(recs)
    steps = sum(f.attrs["iters"] for f in fits)
    cores = _under(recs, name, fits)
    if not steps or not cores or any(s.device_ms is None for s in cores):
        return None
    return sum(s.device_ms for s in cores) / steps
