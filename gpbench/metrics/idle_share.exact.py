"""The device's idle share over the traced large-n steps, in %: one minus the
union of the device events' intervals over the steps' host wall time."""


def read(data):
    if data.get("kind") != "exact":
        return None
    span = data["span"]
    busy = span.busy_union_us / 1e6
    return 100.0 * (1.0 - busy / span.wall_s) if span.wall_s > 0 and busy > 0 else None
