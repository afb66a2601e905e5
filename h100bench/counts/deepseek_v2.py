"""FLOPs and bytes of a DeepSeek-V2 decoder's serving (latent attention,
a leading dense MLP, then routed and shared experts), counted from its
configuration."""


def attention_params(cfg) -> int:
    """A latent-attention layer's weights in matrix products: q at full
    rank (d · H · (nope + rope)), the latent and roped key (d · (r +
    rope)), the latent's up-projection to every head's key and value (r ·
    H · (nope + v)) and the output (H · v · d)."""
    d, h, r = cfg["d_model"], cfg["num_heads"], cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return (d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v)
            + h * v * d)


def expert_params(cfg) -> int:
    """One routed expert's gated MLP."""
    return 3 * cfg["d_model"] * cfg["moe_d_ff"]


def ffn_params(cfg, layer: int, routed: float) -> float:
    """Layer ``layer``'s FFN weights that a token (``routed`` the routed
    experts it reaches) reads: the dense MLP in the leading layers, else
    the router, ``routed`` experts and the shared experts."""
    d = cfg["d_model"]
    if layer < cfg["first_dense_layers"]:
        return 3 * d * cfg["first_dense_d_ff"]
    return (d * cfg["num_experts"] + routed * expert_params(cfg)
            + cfg["num_shared_experts"] * expert_params(cfg))


def prefill_flops(cfg, mix) -> float:
    """One prefill of ``batch`` prompts of ``prompt_len``: 2 a weight and
    token through every layer at the top k of the routed experts (the
    active parameters), the head at each prompt's last position only, and
    causal attention's two products at the model's widths, 2 · (nope +
    rope) for the scores and 2 · v for the output, a (query, key) pair and
    head, over the pairs of a query and a key at or before it."""
    b, p = mix["batch"], mix["prompt_len"]
    layers = cfg["num_layers"]
    per_token = sum(attention_params(cfg)
                    + ffn_params(cfg, i, cfg["moe_top_k"])
                    for i in range(layers))
    width = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
             + cfg["v_head_dim"])
    pairs = p * (p + 1) // 2
    return (2.0 * per_token * b * p + 2.0 * cfg["d_model"] * cfg["vocab_size"]
            * b + 2.0 * width * cfg["num_heads"] * pairs * layers * b)


def experts_touched(cfg, tokens: int) -> float:
    """Routed experts a step reads, in expectation under uniform routing:
    each of ``tokens`` tokens picks ``moe_top_k`` distinct experts of
    ``num_experts``, so an expert is missed by all with probability ``(1 -
    k / E)^tokens``, and E · (1 - (1 - k / E)^tokens) are read."""
    e, k = cfg["num_experts"], cfg["moe_top_k"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def decode_step_bytes(cfg, mix) -> float:
    """The least bytes of a decode step, averaged over a call's steps:
    every weight of a matrix product that the step uses read once in the
    model's type (2 bytes), the routed experts as :func:`experts_touched`
    at ``batch`` tokens, one embedding row a request, and the latent cache
    (``kv_lora_rank + qk_rope_head_dim`` values a position and layer, 2
    bytes each) as far as it is filled, read once."""
    b, p, n = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    d, layers = cfg["d_model"], cfg["num_layers"]
    routed = experts_touched(cfg, b)
    weights = 2.0 * (sum(attention_params(cfg) + ffn_params(cfg, i, routed)
                         for i in range(layers))
                     + d * cfg["vocab_size"] + b * d)
    mean_len = p + (n + 1) / 2.0
    per_pos = (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * 2
    return weights + layers * b * mean_len * per_pos
