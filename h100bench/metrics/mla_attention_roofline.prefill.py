"""Kernels: latent attention's prefill product as a share of its roofline
at the model's own widths: the profiled call's forward ``flash_attention``
launches (one a layer) times one layer's least time with q and k at nope
+ rope and v at v_head_dim (``counts/mla_attention``), over the device
time of those launches, which compute it padded to head size 256."""


def read(ctx):
    t = ctx.get("trace") or {}
    ops = [(s, e) for s, e, n in t.get("ops") or []
           if "flash_attention" in n and "bwd" not in n]
    spent = sum(e - s for s, e in ops) / 1e6
    if not ops or spent <= 0:
        return None
    cfg, mix = ctx["config"], ctx["mix"]
    if not cfg.get("kv_lora_rank"):
        return None
    count = ctx["bench"].counts("mla_attention")
    one = count.bound_s(mix["batch"] * cfg["num_heads"], mix["prompt_len"],
                        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                        cfg["v_head_dim"])
    return 100.0 * len(ops) * one / spent
