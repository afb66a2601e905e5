from repro_torch.serving.engine import GenerationResult, ServingEngine  # noqa: F401
from repro_torch.serving.kvcache import grow_caches  # noqa: F401
