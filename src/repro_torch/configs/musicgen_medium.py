"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf:facebook/musicgen-medium]  48L d_model=1536 24H
(GQA kv=24 → MHA) d_ff=6144 vocab=2048.  The EnCodec audio frontend is a
STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings; the backbone consumes codec-token ids (vocab 2048).
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="codec",
    num_patches=0,
    frontend_dim=128,          # EnCodec latent frame width (stub)
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
