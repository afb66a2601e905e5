"""FLOPs of an RWKV6 language model's training step, counted from its
configuration: the matrix products with weights, forward (2 a weight and
token) and backward (4), so 6 a weight and token.  The recurrence's own
chunk products (a few percent at head size 64), the embedding lookup and
the recomputation under remat are not counted."""


def matrix_params(cfg) -> int:
    """Weights that take part in a matrix product: per layer the time
    mix's r, k, v, g and output projections (5 d²) and its low-rank decay
    (2 d · lora), the channel mix's key, value (2 d · d_ff) and receptance
    (d²); and the head (d · vocab)."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    per_layer = 5 * d * d + 2 * d * cfg["rwkv_lora_decay"] + 2 * d * ff + d * d
    return cfg["num_layers"] * per_layer + d * cfg["vocab_size"]


def train_flops(cfg, mix) -> float:
    """Model FLOPs of one step of ``mix["batch"] x mix["seq_len"]`` tokens."""
    return 6.0 * matrix_params(cfg) * mix["batch"] * mix["seq_len"]
