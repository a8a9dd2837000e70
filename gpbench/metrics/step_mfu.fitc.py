"""The whole FITC step's share of the card's fp32 peak over the timed window,
in %: the FLOP of the math (frozen ``fitc_step_flop``) of every step of every
restart of the window's fits, over the window's seconds, over 67 TFLOP/s."""

from gpbench.frozen.peaks import H100_FP32_FLOP_PER_S


def read(data):
    if data.get("kind") != "fitc" or data["window_s"] <= 0:
        return None
    return 100.0 * data["window_flop"] / data["window_s"] / H100_FP32_FLOP_PER_S
