"""Kernels: ``flash_attention``'s share of its roofline over the profiled
call's prefill: its launches times one call's least time at the prefill's
shapes (q ``[batch x heads, prompt, head_dim]``, causal), over the device
time of every forward kernel named ``flash_attention``."""


def read(ctx):
    t = ctx.get("trace") or {}
    ops = [(s, e) for s, e, n in t.get("ops") or []
           if "flash_attention" in n and "bwd" not in n]
    spent = sum(e - s for s, e in ops) / 1e6
    if not ops or spent <= 0:
        return None
    cfg, mix = ctx["config"], ctx["mix"]
    count = ctx["bench"].counts("flash_attention")
    p = mix["prompt_len"]
    one = count.bound_s(mix["batch"] * cfg["num_heads"], p, p,
                        cfg["head_dim"],
                        group=cfg["num_heads"] // cfg["num_kv_heads"])
    return 100.0 * len(ops) * one / spent
