"""The Gram kernels' share of their roofline over the traced large-n steps, in
%: the bound of a step's Gram calls (the forward on all of K_hat, both
backward halves on each row block of each streamed pass; frozen
``gram_roofline``) times the steps, over the Gram kernels' device time. Read
only where the launches counted are those the math needs and every one left
a device event."""


def read(data):
    if data.get("kind") != "exact" or not data["complete"]:
        return None
    span = data["span"]
    want = data["launches_expected"]
    if any(span.launches.get(k, 0) != v for k, v in want.items()):
        return None
    busy = span.kind_us()["gram"]
    return 100.0 * data["steps_bound_us"] * data["steps"] / busy if busy > 0 else None
