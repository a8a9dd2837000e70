"""The Gram kernels' share of their roofline over the longer profiled FITC fit
of each rule, in %: the bound of the Gram calls the math needs (a step's
K(x, u) and K(u, u), forward and both backward halves, counted by the
frozen ``gram_roofline``) times the steps, over the Gram kernels' device
time. Read only where every launch the program counted left a device event
and each fit launched each kernel twice a step."""


def read(data):
    if data.get("kind") != "fitc":
        return None
    bound = busy = 0.0
    for r in data["rules"].values():
        span = r["long_span"]
        if not r["complete"]:
            return None
        if any(span.launches.get(k, 0) != 2 * r["long"] for k in ("fwd", "bwd_rows", "bwd_cols")):
            return None
        bound += data["steps_bound_us"] * r["long"]
        busy += span.kind_us()["gram"]
    return 100.0 * bound / busy if busy > 0 else None
