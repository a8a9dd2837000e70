"""The device's idle share of a whole FITC fit, in %: one minus the device-busy
time of a five-rule fit (each rule's short profiled fit, with its eager
steps and capture, plus its other iterations at the replayed step's busy
time, from the device trace) over the untraced window's time per fit."""

from gpbench.metrics._fitc import whole_fit_busy_s


def read(data):
    if data.get("kind") != "fitc" or data["fits"] <= 0:
        return None
    busy = whole_fit_busy_s(data)
    per_fit = data["window_s"] / data["fits"]
    return 100.0 * (1.0 - busy / per_fit) if busy > 0 else None
