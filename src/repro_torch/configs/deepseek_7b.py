"""DeepSeek-7B — llama-architecture dense decoder (kv=heads → MHA).

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base]  30L d_model=4096
32H (GQA kv=32) d_ff=11008 vocab=102400.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    # MHA (kv=32): the 32k×128 decode cache is 4.1 TB in bf16 — 16 GB/chip
    # on the 256-chip pod, over HBM with params.  Quantized KV (int8 +
    # per-position scales) halves it; accuracy impact bounded in tests.
    kv_cache_dtype="int8",
)
