"""The port's profiler spans (``repro_torch.spans``), on the CPU.

A tiny dense model serves a batch and a tiny RWKV-6 model trains through
``train()`` under ``torch.profiler``: every span of the serving and
training paths appears, as often and nested as the paths make them, as a
host range and never as a user annotation; the results are the same bits
with and without a profiler running; and with none running a span is the
one shared null context.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.config import get_config
from repro_torch.data import pipeline, synthetic
from repro_torch.models import Model
from repro_torch.serving import ServingEngine
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

NEW_TOKENS = 3
STEPS = 2
N_MB = 2
LAYERS = 2


def _dense():
    return dataclasses.replace(
        get_config("deepseek-7b"), num_layers=LAYERS, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        dtype="float32", kv_cache_dtype="int8")


def _rwkv(mb_tokens: int):
    return dataclasses.replace(
        get_config("rwkv6-7b"), num_layers=LAYERS, d_model=64, d_ff=128,
        vocab_size=256, rwkv_head_dim=16, rwkv_lora_decay=8, rwkv_lora_mix=8,
        chunk_len=8, dtype="float32", microbatch_tokens_per_device=mb_tokens)


def _serve(profiled: bool):
    """A call of 2 prompts of 8 tokens and NEW_TOKENS new ones: (tokens,
    the profiler's events or None)."""
    cfg = _dense()
    model = Model(cfg, device="cpu")
    params = model.init(model.generator(0))
    engine = ServingEngine(model, params, max_new_tokens=NEW_TOKENS)
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)))
    if not profiled:
        return engine.generate({"tokens": prompts}).tokens, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = engine.generate({"tokens": prompts})
    return res.tokens, prof.events()


def _train(profiled: bool, n_mb: int = N_MB):
    """STEPS steps of ``train()`` on batches of 4 x 16 tokens in ``n_mb``
    microbatches: (the losses and the final parameters, the profiler's
    events or None)."""
    cfg = _rwkv(64 // n_mb)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 16, 4),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    train=TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=10))
    assert run.microbatches() == n_mb
    model = Model(cfg, device="cpu")
    corpus = synthetic.lm_token_corpus(1 << 12, cfg.vocab_size,
                                       shard_tokens=1 << 10)
    feed = pipeline.SubsamplingBatchPipeline(
        corpus, pipeline.PipelineConfig(batch_size=4, seq_len=16)).batches()
    kept = {}

    class Keep:
        def save(self, step, state):
            kept["params"] = state.params

        def wait(self):
            pass

    def go():
        return loop.train(model, run, feed, STEPS,
                          state=loop.init_state(model, run),
                          checkpoint_manager=Keep(), checkpoint_every=STEPS,
                          log_every=1 << 30)

    try:
        if not profiled:
            report, events = go(), None
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                report = go()
            events = prof.events()
    finally:
        feed.close()
    return (report.losses, tree_leaves(kept["params"])), events


@pytest.fixture(scope="module")
def served():
    return _serve(profiled=True)[1]


@pytest.fixture(scope="module")
def trained():
    return _train(profiled=True)[1]


def _program(events, name):
    return [e for e in events if e.name == spans.PREFIX + name]


def _enclosing(e):
    """The nearest program span around ``e`` (its name without the
    prefix), or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(spans.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(spans.PREFIX):]


# span, how many a call makes, the program spans that may enclose it
SERVE_SPANS = [
    ("serve.prefill", 1, {None}),
    ("serve.cache_grow", 1, {None}),
    ("serve.decode_step", NEW_TOKENS, {None}),
    ("layer.mix", LAYERS * (1 + NEW_TOKENS),
     {"serve.prefill", "serve.decode_step"}),
    ("layer.ffn", LAYERS * (1 + NEW_TOKENS),
     {"serve.prefill", "serve.decode_step"}),
    ("attention.cache", LAYERS * NEW_TOKENS, {"layer.mix"}),
]

# the layers run twice a microbatch: forward, and remat's recompute in the
# backward (on the CPU autograd runs the backward on the calling thread)
TRAIN_SPANS = [
    ("train.step", STEPS, {None}),
    ("train.to_device", STEPS, {"train.step"}),
    ("train.microbatch", STEPS * N_MB, {"train.step"}),
    ("train.optimizer", STEPS, {"train.step"}),
    ("train.loss_read", STEPS, {"train.step"}),
    ("pipeline.wait", STEPS, {None}),
    ("layer.mix", 2 * STEPS * N_MB * LAYERS, {"train.microbatch"}),
    ("layer.ffn", 2 * STEPS * N_MB * LAYERS, {"train.microbatch"}),
]


@pytest.mark.parametrize("name,count,within", SERVE_SPANS,
                         ids=[s[0] for s in SERVE_SPANS])
def test_serving_spans_count_and_nest(served, name, count, within):
    got = _program(served, name)
    assert len(got) == count
    assert {_enclosing(e) for e in got} <= within
    assert all(e.time_range.end >= e.time_range.start for e in got)


@pytest.mark.parametrize("name,count,within", TRAIN_SPANS,
                         ids=[s[0] for s in TRAIN_SPANS])
def test_training_spans_count_and_nest(trained, name, count, within):
    got = _program(trained, name)
    assert len(got) == count
    assert {_enclosing(e) for e in got} <= within


@pytest.mark.parametrize("path", ["serve", "train"])
def test_spans_are_host_ranges_not_user_annotations(served, trained, path):
    events = served if path == "serve" else trained
    ours = [e for e in events if e.name.startswith(spans.PREFIX)]
    assert ours
    assert not any(e.is_user_annotation for e in ours)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)


def test_every_span_of_a_path_is_named_in_its_table(served, trained):
    for events, table in ((served, SERVE_SPANS), (trained, TRAIN_SPANS)):
        names = {e.name[len(spans.PREFIX):] for e in events
                 if e.name.startswith(spans.PREFIX)}
        assert names == {name for name, _, _ in table}


def test_a_microbatch_span_holds_its_forward_and_backward(trained):
    """Each microbatch span encloses its layers' forward and (on the CPU)
    their recompute, so it holds 2 x LAYERS mix spans."""
    for mb in _program(trained, "train.microbatch"):
        inside = [e for e in _program(trained, "layer.mix")
                  if mb.time_range.start <= e.time_range.start
                  and e.time_range.end <= mb.time_range.end]
        assert len(inside) == 2 * LAYERS


def test_a_single_microbatch_is_one_span_a_step():
    _, events = _train(profiled=True, n_mb=1)
    assert len(_program(events, "train.microbatch")) == STEPS
    assert {_enclosing(e) for e in _program(events, "train.microbatch")} == {
        "train.step"}


def test_serving_is_bit_for_bit_the_same_under_the_profiler():
    plain, _ = _serve(profiled=False)
    traced, _ = _serve(profiled=True)
    assert np.array_equal(plain, traced)


def test_training_is_bit_for_bit_the_same_under_the_profiler():
    (losses, leaves), _ = _train(profiled=False)
    (losses_t, leaves_t), _ = _train(profiled=True)
    assert losses == losses_t
    assert len(leaves) == len(leaves_t)
    assert all(torch.equal(a, b) for a, b in zip(leaves, leaves_t))


def test_without_a_profiler_a_span_is_the_shared_null_context():
    a, b = spans.span("serve.decode_step"), spans.span("train.step")
    assert a is b
    with a as entered:
        assert entered is None


def test_a_span_records_only_while_a_profiler_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with spans.span("inner"):
                torch.ones(4).sum()
    with spans.span("after"):
        pass
    names = [e.name for e in prof.events()
             if e.name.startswith(spans.PREFIX)]
    assert names == ["repro_torch.outer", "repro_torch.inner"]
    inner = [e for e in prof.events() if e.name == "repro_torch.inner"][0]
    assert _enclosing(inner) == "outer"
    assert spans.span("after") is spans.span("again")


def test_the_control_plane_still_loads_no_torch():
    code = ("import sys\nimport repro_torch.core, repro_torch.spans\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
