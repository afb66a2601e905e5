from repro_torch.roofline import hw  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    CellCost,
    RooflineTerms,
    collective_bytes,
    extrapolate,
    model_flops_per_step,
    roofline,
)
