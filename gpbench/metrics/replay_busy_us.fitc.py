"""Device-busy microseconds of one replayed step of the GD loop (the sum of
its device events' durations), weighted over the rules by their iterations."""

from gpbench.metrics._fitc import per_replayed_step


def read(data):
    v = per_replayed_step(data, lambda span: span.busy_sum_us)
    return v if v is not None and v > 0 else None
