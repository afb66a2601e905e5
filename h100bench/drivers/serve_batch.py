"""The ``serve_batch`` kind of mix: batch inference as a closed loop of
back-to-back ``ServingEngine.generate`` calls, each a batch of prompts and
a fixed number of greedy new tokens.

Set-up makes the weights and every call's prompts from the seed, loads
the kernels with a short call and warms the cell's one shape up with one
full call.  The window makes as many calls as
fill ``--seconds`` at the warm-up's time.  A request's time to first token
is its call's prefill phase (``GenerationResult.prefill_seconds``, closed
by a synchronise); the harness checks that a call's two phases sum to no
more than its own clock around the call.  After the window the program's
state is freed and the plain reference reads a sample of the served
requests, drawn from the seed: the widest gap by which a served token's
logit lies below the reference's best at its position.

The mix file gives ``batch``, ``prompt_len``, ``new_tokens`` and
``checked`` (the requests the reference reads).
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from h100bench import core, trace, weights


def prompts(job: core.Job, i: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """Call ``i``'s prompts, uniform token ids drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(
        core.derive_seed(job.seed, f"prompts/{i}"))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)


def run(job: core.Job) -> core.Outcome:
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cuda = job.device == "cuda"
    cfg = core.model_config(job.config)
    mix = job.mix
    b, plen, new = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    model = Model(cfg, device=job.device)
    defs = model.param_defs()
    specs = weights.leaf_specs(defs, model.dtype)
    wseed = core.derive_seed(job.seed, "weights")
    engine = ServingEngine(
        model, weights.build_tree(defs, weights.make(specs, wseed,
                                                     model.device)),
        max_new_tokens=new)

    # a short call first loads (in a checkout's first run: builds) every
    # kernel, so that the full warm-up call times the window's calls
    warm = prompts(job, -1, b, plen, cfg.vocab_size, model.device)
    engine.generate({"tokens": warm}, new_tokens=2)
    t = time.perf_counter()
    engine.generate({"tokens": warm}, new_tokens=new)
    n = max(2, round(job.seconds / (time.perf_counter() - t)))
    calls = [prompts(job, i, b, plen, cfg.vocab_size, model.device)
             for i in range(n)]
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    results, clocks = [], []
    traced: Dict = {}
    core.settle()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    t_a = time.perf_counter()
    for i, toks in enumerate(calls):
        c0 = time.perf_counter()
        if job.trace and i == n - 1:
            with trace.window(job.device) as traced:
                with trace.span("call"):
                    res = engine.generate({"tokens": toks}, new_tokens=new)
        else:
            res = engine.generate({"tokens": toks}, new_tokens=new)
        clocks.append(time.perf_counter() - c0)
        results.append(res)
    t_b = time.perf_counter()
    launches = {k: ops.launch_count(k) for k in ops.KERNELS}
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    failed = 0
    for res, wall in zip(results, clocks):
        bad = ((res.prefill_seconds + res.decode_seconds > wall)
               or res.tokens.shape != (b, new)
               or not ((res.tokens >= 0)
                       & (res.tokens < cfg.vocab_size)).all())
        failed += b if bad else 0

    # the check: a sample of the served requests through the reference
    rng = np.random.default_rng(core.derive_seed(job.seed, "checked"))
    pick = sorted(rng.choice(n * b, size=min(mix["checked"], n * b),
                             replace=False).tolist())
    ref_mod = job.bench.reference(job.config["architecture"])
    leaves = weights.make(specs, wseed, model.device)
    p_rows = torch.stack([calls[r // b][r % b] for r in pick])
    s_rows = torch.as_tensor(np.stack([results[r // b].tokens[r % b]
                                       for r in pick]), device=model.device)
    logits = ref_mod.served_logits(job.config, leaves, p_rows, s_rows)
    gap = float(ref_mod.widest_gaps(logits, s_rows).max())
    del leaves, logits
    checks = {"logit_gap": (gap, job.limits["logit_gap"])}
    print("h100bench calls " + json.dumps(
        [[r.prefill_seconds, r.decode_seconds, w]
         for r, w in zip(results, clocks)]), file=sys.stderr)

    untraced = [r for i, r in enumerate(results)
                if not (job.trace and i == n - 1)]
    layer: Dict = {"prefill_s": [r.prefill_seconds for r in untraced],
                   "decode_step_s": [r.decode_seconds / new
                                     for r in untraced],
                   "launches": launches, "calls": n, "trace": traced}
    if traced:
        # the traced call's prefill and decode, split on the host clock
        start = traced["spans"]["call"][0][0]
        cut = start + results[-1].prefill_seconds * 1e6
        traced["phases"] = {"prefill": (start, cut),
                            "decode": (cut, traced["spans"]["call"][0][1])}
    requests = n * b
    out = core.Outcome(
        end_to_end={"setup_s": t_a - job.t0,
                    "ttft_mean_s": float(np.mean(
                        [r.prefill_seconds for r in results])),
                    "serve_tokens_per_s": requests * new / (t_b - t_a),
                    "peak_mem_gib": window_peak / 2**30},
        checks=checks, attempted=requests, failed=failed,
        memory_peak_bytes=max(setup_peak, window_peak), layer=layer)
    if traced:
        out.busy_s, out.window_s = trace.device_busy(traced)
        spans = dict(traced["spans"])
        spans.pop("call", None)
        for name, (lo, hi) in traced["phases"].items():
            spans[name] = [(lo, hi)]
        out.breakdown = trace.breakdown(dict(traced, spans=spans), "harness")
    return out
