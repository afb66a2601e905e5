"""DeepSeekMoE-16B — fine-grained MoE: 64 routed experts top-6 plus 2
shared experts; the first layer uses a dense FFN.

[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]  28L d_model=2048
16H (GQA kv=16 → MHA) d_ff=1408 vocab=102400, MoE 64e top-6.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                # routed-expert FFN width (fine-grained)
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,   # hf config: intermediate_size of dense layer 0
    rope_theta=10_000.0,
    norm_eps=1e-6,
    moe_seq_chunk=1024,
)
