"""FLOPs and bytes of a llama-architecture decoder's serving, counted from
its configuration."""


def layer_matrix_params(cfg) -> int:
    """A layer's weights in matrix products: q, k, v, o and the gated MLP."""
    d = cfg["d_model"]
    q = cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    return d * q + 2 * d * kv + q * d + 3 * d * cfg["d_ff"]


def prefill_flops(cfg, mix) -> float:
    """One prefill of ``batch`` prompts of ``prompt_len``: 2 a weight and
    token through every layer, the head at each prompt's last position
    only, and causal attention's two products (2 · head_dim each) over the
    pairs of a query and a key at or before it."""
    b, p = mix["batch"], mix["prompt_len"]
    hd, h = cfg["head_dim"], cfg["num_heads"]
    pairs = p * (p + 1) // 2
    return (2.0 * cfg["num_layers"] * layer_matrix_params(cfg) * b * p
            + 2.0 * cfg["d_model"] * cfg["vocab_size"] * b
            + 4.0 * hd * h * pairs * cfg["num_layers"] * b)


def decode_step_bytes(cfg, mix) -> float:
    """The least bytes of a decode step, averaged over a call's steps:
    every weight of a matrix product read once in the model's type (2
    bytes), one embedding row a request, and the KV cache as far as it is
    filled (int8 values with one fp32 scale a position and head where
    ``kv_cache_dtype`` is int8, else 2 bytes a value), read once."""
    b, p, n = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    d, layers = cfg["d_model"], cfg["num_layers"]
    weights = 2.0 * (layers * layer_matrix_params(cfg)
                     + d * cfg["vocab_size"] + b * d)
    mean_len = p + (n + 1) / 2.0
    kvh, hd = cfg["num_kv_heads"], cfg["head_dim"]
    if cfg.get("kv_cache_dtype") == "int8":
        per_pos = 2 * kvh * (hd * 1 + 4)
    else:
        per_pos = 2 * kvh * hd * 2
    return weights + layers * b * mean_len * per_pos
