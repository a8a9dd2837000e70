"""Sweeps over restarts and replicates (port of `gpscore/parallel/`; the
sharded modules, the device mesh among them, are not ported yet)."""

from gpscore_torch.parallel.sweeps import default_sweep_generator, restart_sweep

__all__ = ["default_sweep_generator", "restart_sweep"]
