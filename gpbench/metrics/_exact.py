"""Reductions shared by the exact-GP readers: device time by kind of kernel
(the frozen ``kernel_kind``) per step of the traced steps."""


def kind_ms_per_step(data, kind):
    if data.get("kind") != "exact" or data["steps"] <= 0:
        return None
    us = data["span"].kind_us()[kind]
    return us / 1e3 / data["steps"] if us > 0 else None
