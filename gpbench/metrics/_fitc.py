"""Reductions shared by the FITC readers: per replayed step, from the two
profiled fits of each rule (their difference is replays alone), weighted
over the rules by their iterations."""


def per_replayed_step(data, field):
    """The iteration-weighted mean over rules of ``field(span)``'s change per
    replayed step, or None outside a FITC trace."""
    if data.get("kind") != "fitc":
        return None
    total = weight = 0.0
    for r in data["rules"].values():
        steps = r["long"] - r["short"]
        if steps <= 0:
            return None
        total += (field(r["long_span"]) - field(r["short_span"])) / steps * r["iters"]
        weight += r["iters"]
    return total / weight


def whole_fit_busy_s(data):
    """Device-busy seconds of one whole fit of every rule: the short fit's
    (its eager steps and capture) plus the rest of the rule's iterations at
    the replayed step's busy time."""
    total = 0.0
    for r in data["rules"].values():
        s, l = r["short_span"], r["long_span"]
        per = (l.busy_sum_us - s.busy_sum_us) / (r["long"] - r["short"])
        total += (s.busy_sum_us + per * (r["iters"] - r["short"])) / 1e6
    return total
