"""Snowflake Arctic (480B) — dense-MoE hybrid: every layer has a dense
residual FFN in parallel with a 128-expert top-2 MoE.

[hf:Snowflake/snowflake-arctic-base]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                # dense residual FFN width
    vocab_size=32000,
    num_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    moe_seq_chunk=2048,
    # 960 GB of bf16 weights cannot be replicated across the data axis even
    # for serving: expert/embed dims stay FSDP-sharded and are gathered per
    # layer (weight-gathered serving).
    serve_shard_embed=True,
)
