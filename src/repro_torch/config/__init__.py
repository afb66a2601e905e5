from repro_torch.config.base import (  # noqa: F401
    ATTN,
    LOCAL,
    MULTI_POD_MESH,
    RGLRU,
    RWKV,
    SHAPES,
    SINGLE_POD_MESH,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.config.registry import ARCH_IDS, all_configs, get_config  # noqa: F401
