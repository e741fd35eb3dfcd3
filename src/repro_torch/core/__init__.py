"""WSMC capacity model: expansion-ratio profiles, classification and the
closed-form capacity predictor (Liang, Chang, Su 2017). The measurement,
profiling and planning front end is not part of this package yet."""
from repro_torch.core.classifier import (  # noqa: F401
    Category, Classification, FACTOR_SHUF, classify, classify_profiles,
)
from repro_torch.core.expansion import (  # noqa: F401
    MemoryProfile, expansion_ratio, increasing_rate, mean_expansion_ratio,
)
from repro_torch.core.predictor import (  # noqa: F401
    CapacityPrediction, MemoryPlan, min_devices, predict,
)
