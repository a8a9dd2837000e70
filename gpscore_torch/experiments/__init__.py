"""The four experiment drivers of the reference scripts (port of
`experiments/{kin40k_full,simple_full,kin40k_fitc,simple_fitc}.py`), each run
as ``python -m gpscore_torch.experiments.<name> [--device cuda|cpu] ...``,
and their shared sweep machinery (:mod:`gpscore_torch.experiments.common`)."""
