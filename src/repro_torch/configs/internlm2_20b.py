"""InternLM2-20B — dense GQA decoder.

[arXiv:2403.17297; hf:internlm/internlm2-20b]  48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92544.
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
)
