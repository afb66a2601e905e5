"""DeepSeek-67B — llama-architecture dense GQA decoder.

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base]  95L d_model=8192
64H (GQA kv=8) d_ff=22016 vocab=102400.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    norm_eps=1e-6,
)
