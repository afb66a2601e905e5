"""RecurrentGemma-2B (Griffin) — RG-LRU recurrent blocks + local attention
in a 1:2 pattern (two recurrent blocks, then one local-attention block).

[arXiv:2402.19427; hf:google/recurrentgemma-2b]  26L d_model=2560 10H
(GQA kv=1 → MQA) d_ff=7680 vocab=256000.  Local window 2048 → decode state
is bounded → runs the long_500k cell.
"""

from repro_torch.config.base import LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL),
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    logit_soft_cap=30.0,
    tie_embeddings=True,
    chunk_len=128,
)
