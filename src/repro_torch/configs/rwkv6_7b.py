"""RWKV6 (Finch) 7B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]  32L d_model=4096 (attn-free)
d_ff=14336 vocab=65536.  64 heads of size 64; decode state is O(1) in
sequence length → runs the long_500k cell.
"""

from repro_torch.config.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=(RWKV,),
    rwkv_head_dim=64,
    rwkv_lora_decay=64,
    rwkv_lora_mix=32,
    norm_eps=1e-5,
    # kneepoint-tuned chunked-recurrence length: the measured working-set
    # knee for train_4k on v5e-256 (EXPERIMENTS §Perf: 64 fits the 16 GB
    # HBM budget at zero compute/collective cost; 128 → 22.5 GiB peak,
    # 256 → 40.8 GiB)
    chunk_len=64,
)
