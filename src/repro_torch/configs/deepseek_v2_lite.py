"""DeepSeek-V2-Lite — multi-head latent attention over a latent KV cache
with YaRN-scaled RoPE, and a fine-grained MoE (64 routed experts top-6 by
softmax, not renormalised, plus 2 shared experts) after one dense layer.

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite config.json]  27L
d_model=2048 16H, q at full rank, kv_lora_rank 512, qk 128 + 64 roped,
v 128; YaRN factor 40 over 4,096 original positions; dense layer 0 of
10,944; vocab 102400 untied; context 163,840.  The cache holds a token's
normed latent and its roped key, 576 values a layer, in bf16.
"""

from repro_torch.config.base import MLA, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,             # v_head_dim: the width of a head's output
    d_ff=1408,                # moe_intermediate_size
    vocab_size=102400,
    layer_pattern=(MLA,),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    rope_scaling={"type": "yarn", "factor": 40,
                  "original_max_position_embeddings": 4096,
                  "beta_fast": 32, "beta_slow": 1,
                  "mscale": 0.707, "mscale_all_dim": 0.707},
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,   # intermediate_size of dense layer 0
    norm_topk_prob=False,
    moe_dispatch="dropless",
    # dropless routing: a segment changes memory only, never the result
    moe_seq_chunk=4096,
    norm_eps=1e-6,
)
