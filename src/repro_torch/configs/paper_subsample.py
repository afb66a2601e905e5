"""The paper's own workload configuration: data-parallel statistical
subsampling (EAGLET-like genetic-linkage statistics and Netflix-like rating
statistics), executed as tiny tasks on the platform in ``repro_torch.core``.

Model-shaped fields are unused for this config; the meaningful knobs are the
task-plane fields.  Workload parameters live in ``repro_torch.data.synthetic``
and in the reference's ``repro.core.subsample`` (not yet ported).
"""

from repro_torch.config.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-subsample",
    family="subsample",
    num_layers=0,
    d_model=0,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=0,
    chunk_len=128,
)
