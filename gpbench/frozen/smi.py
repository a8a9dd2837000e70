"""The card's name and power limit from ``nvidia-smi``.

Copied from ``gpscore_torch/bench_gram.py:59-64`` (``nvidia_smi_line``); returns
None where ``nvidia-smi`` is missing or fails instead of raising.
"""

import subprocess


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None
