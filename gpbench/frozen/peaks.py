"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the 700 W limit).

Copied from ``gpscore_torch/ops/gram_cuda.py:86-92`` (the roofline's peaks).
"highest" runs IEEE fp32 outside the tensor cores (TF32 off), so every share of
a peak here is against the fp32 non-tensor rate.
"""

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12
H100_FP64_FLOP_PER_S = 67e12
