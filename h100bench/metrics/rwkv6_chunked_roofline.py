"""Kernels: ``rwkv6_chunked``'s share of its roofline over the profiled
steps: the calls (one ``rwkv6_chunked_state_kernel`` launch each) times
one call's least time at the microbatch's shapes, over the device time of
every kernel named ``rwkv6_chunked``."""


def read(ctx):
    t = ctx.get("trace") or {}
    ops = t.get("ops") or []
    calls = sum(1 for _, _, n in ops if "rwkv6_chunked_state_kernel" in n)
    spent = sum(e - s for s, e, n in ops if "rwkv6_chunked" in n) / 1e6
    if not calls or spent <= 0:
        return None
    cfg, mix = ctx["config"], ctx["mix"]
    count = ctx["bench"].counts("rwkv6_chunked")
    hd = cfg["rwkv_head_dim"]
    one = count.bound_s(mix["batch"] // ctx["microbatches"],
                        cfg["d_model"] // hd, mix["seq_len"], hd,
                        min(cfg["chunk_len"], mix["seq_len"]))
    return 100.0 * calls * one / spent
