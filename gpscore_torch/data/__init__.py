from gpscore_torch.data.kin40k import (
    Kin40k,
    ReplicateSplit,
    kin40k_fitc20_init,
    kin40k_replicate_split,
    load_kin40k,
    synthesize_kin40k_like,
)
from gpscore_torch.data.synthetic import SyntheticSplit, sample_synthetic_1d

__all__ = [
    "Kin40k",
    "ReplicateSplit",
    "kin40k_replicate_split",
    "load_kin40k",
    "synthesize_kin40k_like",
    "kin40k_fitc20_init",
    "SyntheticSplit",
    "sample_synthetic_1d",
]
