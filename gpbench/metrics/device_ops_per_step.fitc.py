"""Device operations (kernels, copies, sets) of one replayed step of the
objectives, model and rules, weighted over the rules by their iterations."""

from gpbench.metrics._fitc import per_replayed_step


def read(data):
    v = per_replayed_step(data, lambda span: span.n_device)
    return v if v is not None and v > 0 else None
