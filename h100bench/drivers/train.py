"""The ``train`` kind of mix: a training job through the program's own
loop, ``repro_torch.train.loop.train``.

Set-up makes the weights from the seed, the training state around them
(AdamW's moments by ``adamw.init``), a Zipfian token corpus from the seed
and the paper's ``SubsamplingBatchPipeline`` over it, then drives that one
state through the first three steps of ``train()``, the window's own call
and feed.  A checkpoint manager of the benchmark's hands each state back
(``train()`` returns none): after step 1 it reads every leaf's first
gradient from AdamW's first moment, after step 2 every leaf's change, and
after steps 2 and 3 a fingerprint of every leaf.  The window then
continues the same state for as many steps as fill ``--seconds`` at the
set-up's step time; its last state is fingerprinted once the window has
closed, so that a leaf that moved in step 3 and not in the window shows.
After the window the program's state is freed and the plain reference
takes the same weights and the same first two batches through two steps
of its own.

The mix file gives ``batch``, ``seq_len`` and the corpus (``tokens``,
``shard_tokens``, Zipf ``exponent``); the configuration file gives the
model and its ``train`` recipe.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from h100bench import core, trace, weights

SETUP_STEPS = 3          # the program's steps before the window
CHECKED_STEPS = 2        # the first steps the reference follows: their
#                          losses, the first gradient and the change
# leaves whose first gradient is compared element by element, as
# (path, index of the stacked layer or None): the head and the final norm,
# which the backward reaches first, and the last layer's slice of the
# leaves it reaches through one RWKV layer alone (the recurrence's
# backward gives dk, dv, dr, dlogw and du; the channel mix's its key),
# before any rounding is amplified through the layers below
DIRECTION_LEAVES = {
    "head": ("embed/head", None),
    "final_norm": ("final_norm/scale", None),
    "last.mix.wr": ("blocks/0/mix/wr", -1),
    "last.mix.wk": ("blocks/0/mix/wk", -1),
    "last.mix.wv": ("blocks/0/mix/wv", -1),
    "last.mix.decay_b": ("blocks/0/mix/decay_b", -1),
    "last.mix.bonus_u": ("blocks/0/mix/bonus_u", -1),
    "last.ffn.wk": ("blocks/0/ffn/wk", -1),
}
TRACED_STEPS = 2         # window steps under the profiler with --trace 1


def corpus(spec: Dict, vocab: int, seed: int) -> Dict[int, np.ndarray]:
    """Token shards with Zipfian frequencies (exponent ``spec["exponent"]``
    over a seeded permutation of the vocabulary)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** spec["exponent"]
    cdf = np.cumsum(probs / probs.sum())
    ids = rng.permutation(vocab).astype(np.int32)
    n = spec["tokens"] // spec["shard_tokens"]
    draws = np.searchsorted(cdf, rng.random(n * spec["shard_tokens"]))
    toks = ids[np.minimum(draws, vocab - 1)]
    return {i: toks[i * spec["shard_tokens"]:(i + 1) * spec["shard_tokens"]]
            for i in range(n)}


class Feed:
    """The pipeline's iterator as ``train()`` reads it: host seconds
    inside each ``next()`` and the host clock at each, the first batches
    kept for the reference, and a hook run at the start of each step."""

    def __init__(self, it, keep: int):
        self.it = it
        self.keep = keep
        self.kept: List[Dict[str, np.ndarray]] = []
        self.stamps: List[float] = []
        self.inside: List[float] = []
        self.hook = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.hook is not None:
            self.hook(len(self.stamps))
        t = time.perf_counter()
        self.stamps.append(t)
        with trace.span("pipeline"):
            batch = next(self.it)
        self.inside.append(time.perf_counter() - t)
        if len(self.kept) < self.keep:
            self.kept.append({k: np.array(v) for k, v in batch.items()})
        return batch


def fingerprints(params) -> Dict[str, int]:
    """Each leaf's bit patterns summed exactly: a leaf any element of
    which has changed reads another number (but for a cancellation that no
    optimizer step makes)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return {p: int(t.detach().view(ints[t.element_size()])
                   .sum(dtype=torch.int64))
            for p, t in weights.flatten(params).items()}


class Keeper:
    """A checkpoint manager that keeps the state ``train()`` saves (by
    reference, nothing copied) and reads the check's numbers from it."""

    def __init__(self, beta1: float, params0=None):
        self.beta1 = beta1
        self.params0 = params0
        self.state = None
        self.step = None
        self.grad_norms: Dict[str, float] = {}
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.change_norms: Dict[str, float] = {}
        self.marks: Dict[int, Dict[str, int]] = {}

    def save(self, step: int, state) -> None:
        self.step, self.state = int(step), state
        if step == 1 and self.params0 is not None:
            # the first moment after one step from zero is (1 - β1) g
            mu = weights.flatten(state.opt.mu)
            self.grad_norms = {
                p: float(torch.linalg.vector_norm(m.float()))
                / (1.0 - self.beta1) for p, m in mu.items()}
            self.first_grads = {
                name: (mu[p] if i is None else mu[p][i]).float().cpu()
                / (1.0 - self.beta1)
                for name, (p, i) in DIRECTION_LEAVES.items()}
        if step == CHECKED_STEPS and self.params0 is not None:
            now = weights.flatten(state.params)
            self.change_norms = {
                p: float(torch.linalg.vector_norm(now[p].float() - t.float()))
                for p, t in weights.flatten(self.params0).items()}
            self.params0 = None
        if step in (SETUP_STEPS - 1, SETUP_STEPS) and self.grad_norms:
            self.marks[step] = fingerprints(state.params)

    def wait(self) -> None:
        pass

    def restore_latest(self, example=None):
        return None

    def take(self):
        state, self.state = self.state, None
        return state


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf's; ``keep`` the leaves compared (all by default).  A leaf the
    program did not report reads infinite."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return {"": float("inf")}
    med = statistics.median(ref[n] for n in names)
    return {n: (abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                if n in prog else float("inf")) for n in names}


def direction_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a/|a| - b/|b||``: how far two gradients of one leaf point apart,
    whatever either was scaled by (the global clip); 0 for one direction,
    √2 for orthogonal ones, infinite where ``a`` is zero."""
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    if float(na) == 0.0 or float(nb) == 0.0:
        return float("inf")
    return float(torch.linalg.vector_norm(a / na - b / nb))


def unmoved(before: Dict[str, int], after: Dict[str, int],
            now: Dict[str, int]) -> int:
    """The leaves that moved from ``before`` to ``after`` (set-up's step
    3) and read the same at the window's end (``now``): a window whose
    steps stopped updating a leaf.  Leaves that step 3 left as they were
    (a bf16 scale that one update cannot move) are not counted."""
    return sum(1 for p in after
               if after[p] != before.get(p) and now.get(p) == after[p])


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the check can compare: the losses of the steps the
    reference follows (both from the initial parameters: the schedule's
    rate is 0 at step 0), the first gradient's direction at each of
    ``DIRECTION_LEAVES``, of the first gradient's and the change's leaves
    the median and the worst, and the leaves the window left unmoved (0
    where the program's window was not run: the controls').  Leaves whose
    first gradient the reference reads under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    losses = [_rel(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    losses += [float("inf")] * (len(ref["losses"]) - len(losses))
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    gmed = statistics.median(ref["grad_norms"].values())
    moved = {n for n, g in ref["grad_norms"].items() if g >= 1e-3 * gmed}
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    dirs = {f"grad_dir_gap.{name}": direction_gap(
                prog["first_grads"][name], ref["first_grads"][name])
            if name in prog.get("first_grads", {}) else float("inf")
            for name in DIRECTION_LEAVES}
    return {"loss_rel_gap": max(losses), **dirs,
            "grad_norm_gap.median": statistics.median(grads.values()),
            "grad_norm_gap.worst": max(grads.values()),
            "change_norm_gap.median": statistics.median(change.values()),
            "change_norm_gap.worst": max(change.values()),
            "window_unmoved_leaves": float(
                prog.get("window_unmoved_leaves", 0))}


def compare(prog: Dict, ref: Dict, limits: Dict[str, float]) -> Dict:
    """The numbers the cell's limits name, each beside its limit."""
    got = readings(prog, ref)
    return {name: (got[name], limit) for name, limit in limits.items()}


def run(job: core.Job) -> core.Outcome:
    from repro_torch.config.base import (MeshConfig, RunConfig, ShapeConfig,
                                         TrainConfig)
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SubsamplingBatchPipeline)
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cuda = job.device == "cuda"
    cfg = core.model_config(job.config)
    mix = job.mix
    b, s = mix["batch"], mix["seq_len"]
    tcfg = TrainConfig(**job.config["train"])
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig("train", "train", s, b),
                        mesh=MeshConfig((1, 1), ("data", "model")),
                        train=tcfg)
    n_mb = run_cfg.microbatches()
    model = Model(cfg, device=job.device)
    defs = model.param_defs()
    specs = weights.leaf_specs(defs, model.dtype)
    wseed = core.derive_seed(job.seed, "weights")
    params0 = weights.build_tree(defs, weights.make(specs, wseed,
                                                    model.device))
    # in a list that train() empties, so that no local name keeps the
    # initial state (its fp32 moments) alive once the first step replaces it
    first = [loop.TrainState(params0, adamw.init(params0, tcfg), None,
                             torch.zeros((), dtype=torch.int32,
                                         device=model.device))]
    pipe = SubsamplingBatchPipeline(
        corpus(mix["corpus"], cfg.vocab_size,
               core.derive_seed(job.seed, "corpus")),
        PipelineConfig(batch_size=b, seq_len=s,
                       seed=core.derive_seed(job.seed, "pipeline")))
    prefetch = pipe.batches(None)
    feed = Feed(prefetch, keep=CHECKED_STEPS)
    keeper = Keeper(tcfg.beta1, params0)
    del params0
    quiet = 1 << 30

    # set-up: the first steps of the one state, through train()
    setup = loop.train(model, run_cfg, feed, SETUP_STEPS,
                       state=first.pop(), checkpoint_manager=keeper,
                       checkpoint_every=1, log_every=quiet)
    if cuda:
        torch.cuda.synchronize()
    end_setup = time.perf_counter()
    # steps 2 and 3: the first step loads (or builds) the kernels
    steady = [y - x for x, y in zip(feed.stamps[1:SETUP_STEPS],
                                    feed.stamps[2:SETUP_STEPS] + [end_setup])]
    n = max(2, round(job.seconds / statistics.median(steady)))
    if job.trace:
        n = max(n, TRACED_STEPS + 2)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    traced: Dict = {}
    if job.trace:
        lo = SETUP_STEPS + 1            # the window's second step
        running = []

        def hook(i):
            if i in (lo, lo + TRACED_STEPS) and cuda:
                torch.cuda.synchronize()
            if i == lo:
                running.append(trace.start(job.device))
                trace.mark()
            elif i == lo + TRACED_STEPS:
                trace.mark()
                prof = running.pop()
                prof.stop()
                traced.update(trace.read(prof))
        feed.hook = hook

    # the window
    ends = Keeper(tcfg.beta1)
    core.settle()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    t_a = time.perf_counter()
    report = loop.train(model, run_cfg, feed, SETUP_STEPS + n,
                        state=keeper.take(), checkpoint_manager=ends,
                        checkpoint_every=quiet, log_every=quiet)
    if cuda:
        torch.cuda.synchronize()
    t_b = time.perf_counter()
    feed.hook = None
    launches = {k: ops.launch_count(k) for k in ops.KERNELS}
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    done = ends.step
    last = ends.take()
    if last is not None and len(keeper.marks) == 2:
        window_unmoved = unmoved(keeper.marks[SETUP_STEPS - 1],
                                 keeper.marks[SETUP_STEPS],
                                 fingerprints(last.params))
    else:
        window_unmoved = len(specs)      # no state to read: none moved
    del last
    prefetch.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    stamps = feed.stamps[SETUP_STEPS:] + [t_b]
    step_s = [y - x for x, y in zip(stamps, stamps[1:])]
    untraced = [t for i, t in enumerate(step_s)
                if not (job.trace and 1 <= i < 1 + TRACED_STEPS)]
    failed = sum(1 for v in report.losses if not np.isfinite(v))
    if done != SETUP_STEPS + n:
        failed += SETUP_STEPS + n - (done or 0)

    # the check: the reference, once the program's state is gone
    prog = {"losses": list(setup.losses[:CHECKED_STEPS]),
            "grad_norms": keeper.grad_norms,
            "first_grads": keeper.first_grads,
            "change_norms": keeper.change_norms,
            "window_unmoved_leaves": window_unmoved}
    ref_mod = job.bench.reference(job.config["architecture"])
    leaves = weights.make(specs, wseed, model.device)
    ref = ref_mod.train_readings(job.config, leaves, feed.kept, n_mb,
                                 steps=CHECKED_STEPS,
                                 keep_grads=DIRECTION_LEAVES)
    del leaves
    checks = compare(prog, ref, job.limits)
    print("h100bench readings " + json.dumps(
        {"readings": readings(prog, ref), "losses": prog["losses"],
         "reference_losses": ref["losses"]}), file=sys.stderr)

    tokens = b * s
    layer = {"step_s": untraced, "pipeline_s": feed.inside[SETUP_STEPS:],
             "tokens_per_step": tokens, "launches": launches,
             "microbatches": n_mb, "trace": traced}
    out = core.Outcome(
        end_to_end={"setup_s": t_a - job.t0,
                    "train_tokens_per_s": n * tokens / (t_b - t_a),
                    "peak_mem_gib": window_peak / 2**30},
        checks=checks, attempted=n, failed=failed,
        memory_peak_bytes=max(setup_peak, window_peak), layer=layer)
    if traced:
        out.busy_s, out.window_s = trace.device_busy(traced)
        out.breakdown = trace.breakdown(traced, "step")
    return out
