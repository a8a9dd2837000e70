"""The whole large-n step's share of the card's fp32 peak over the timed
window, in %: the frozen ``step_flop`` of each of the window's steps, over the
window's seconds, over 67 TFLOP/s."""

from gpbench.frozen.peaks import H100_FP32_FLOP_PER_S


def read(data):
    if data.get("kind") != "exact" or data["window_s"] <= 0:
        return None
    return (100.0 * data["step_flop"] * data["window_steps"] / data["window_s"]
            / H100_FP32_FLOP_PER_S)
