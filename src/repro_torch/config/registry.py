"""``--arch <id>`` registry.

Each module in ``repro_torch.configs`` defines a module-level ``CONFIG``
(:class:`repro_torch.config.base.ModelConfig`).  Arch ids use dashes
(``qwen2-72b``); module names use underscores (``qwen2_72b``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.base import ModelConfig

ARCH_IDS: List[str] = [
    "qwen2-72b",
    "internlm2-20b",
    "deepseek-67b",
    "deepseek-7b",
    "arctic-480b",
    "deepseek-moe-16b",
    "rwkv6-7b",
    "llava-next-34b",
    "musicgen-medium",
    "recurrentgemma-2b",
    "paper-subsample",
    "deepseek-v2-lite",
]

_CACHE: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _CACHE:
        module_name = arch.replace("-", "_")
        mod = importlib.import_module(f"repro_torch.configs.{module_name}")
        cfg = mod.CONFIG
        assert isinstance(cfg, ModelConfig), arch
        assert cfg.name == arch, (cfg.name, arch)
        _CACHE[arch] = cfg
    return _CACHE[arch]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
