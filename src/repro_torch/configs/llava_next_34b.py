"""LLaVA-NeXT-34B — VLM; the assignment specifies the transformer BACKBONE
only (60L Yi-34B-style GQA decoder).  The anyres-tiling vision frontend is a
STUB: ``input_specs()`` supplies precomputed patch embeddings which are
linearly projected and prepended to the token stream.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="patch",
    num_patches=576,          # 24x24 anyres base grid (stub)
    frontend_dim=1024,        # CLIP-L/14 embedding width (stub)
    rope_theta=5_000_000.0,
    norm_eps=1e-5,
)
