"""Logical-axis sharding rules and parameter definitions
(:mod:`~repro_torch.parallel.sharding`), collectives over a mesh's entries
and the wave mesh's host gather
(:mod:`~repro_torch.parallel.collectives`), and int8 gradient compression
(:mod:`~repro_torch.parallel.compression`)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    BATCH,
    EMBED,
    EXPERT,
    HEADS,
    KV_SEQ,
    LAYERS,
    REPL,
    SEQ,
    SERVE_RULES,
    TRAIN_RULES,
    VOCAB,
    ParamDef,
    init_params,
    logical_to_spec,
    named_sharding,
    param_count,
    tree_shape_structs,
    tree_shardings,
    tree_specs,
)
