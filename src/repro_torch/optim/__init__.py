from repro_torch.optim import adamw  # noqa: F401
from repro_torch.optim.adamw import AdamWState, QuantMoment, lr_schedule  # noqa: F401
