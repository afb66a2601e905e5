"""Reading the port's spans (``program.py``): on a reading without them
(a program that records none) the breakdown is ``trace.breakdown``'s to
the byte and every reader reads None; on synthetic readings that hold
them, the innermost-span rule and each reader give known values; and a
tiny cell run under the CPU profiler reads the spans the port makes."""

from __future__ import annotations

import json

import pytest

import _tiny
from h100bench import program, trace

MAIN, OTHER = 1, 2


def _parent_reading():
    """A reading as ``trace.read`` gives it: device operations, the marked
    window and the harness's spans; gaps at 10-20, 30-45, 60-100."""
    ops = [(0.0, 10.0, "gemm"), (20.0, 30.0, "add"), (45.0, 60.0, "gemm"),
           (100.0, 110.0, "copy")]
    return {"ops": ops, "window": (0.0, 110.0),
            "spans": {"prefill": [(0.0, 25.0)], "decode": [(25.0, 110.0)]}}


def _with_program(reading):
    """The same reading with a decode step (5-105) on the main thread,
    its layers and the cache inside, a span on another thread, and four
    blocking waits, three on the main thread."""
    program_spans = [
        ("serve.decode_step", 5.0, 105.0, MAIN, 40.0),
        ("layer.mix", 12.0, 50.0, MAIN, 20.0),
        ("attention.cache", 14.0, 19.0, MAIN, 1.0),
        ("layer.ffn", 62.0, 70.0, MAIN, 5.0),
        ("train.microbatch", 0.0, 110.0, OTHER, 99.0),
    ]
    waits = [("cudaStreamSynchronize", 11.0, 12.0, MAIN),
             ("cudaStreamSynchronize", 40.0, 44.0, MAIN),
             ("cudaStreamSynchronize", 63.0, 64.0, OTHER),
             ("cudaDeviceSynchronize", 106.0, 107.0, MAIN)]
    return dict(reading, program=sorted(program_spans,
                                        key=lambda s: (s[1], -s[2])),
                waits=waits, main_thread=MAIN)


@pytest.mark.parametrize("extra", [{}, {"program": [], "waits": [],
                                        "main_thread": None}],
                         ids=["parent", "empty"])
@pytest.mark.parametrize("default", ["harness", "step"])
def test_without_program_spans_the_breakdown_is_the_parents(extra, default):
    reading = dict(_parent_reading(), **extra)
    want = trace.breakdown(_parent_reading(), default)
    assert json.dumps(program.breakdown(reading, default)) == json.dumps(want)


def test_a_gap_takes_the_innermost_span_that_covers_most_of_it():
    got = program.idle_gaps(_with_program(_parent_reading()), 0.0, 110.0,
                            "harness")
    # 60-100: layer.ffn covers 8 of 40, the decode step 40: the step;
    # 10-20: attention.cache covers 5 of 10 (not most), layer.mix 8: mix;
    # 30-45: layer.mix 15 of 15
    assert got == [("serve.decode_step", 40.0), ("layer.mix", 15.0),
                   ("layer.mix", 10.0)]


def test_a_gap_no_program_span_covers_keeps_the_harness_name():
    reading = _with_program(_parent_reading())
    reading["program"] = [s for s in reading["program"]
                          if s[0] not in ("serve.decode_step", "layer.mix")]
    got = program.idle_gaps(reading, 0.0, 110.0, "harness")
    assert got == [("decode", 40.0), ("decode", 15.0), ("prefill", 10.0)]


def test_spans_of_other_threads_name_no_gap():
    reading = _with_program(_parent_reading())
    reading["program"] = [s for s in reading["program"] if s[3] == OTHER]
    got = program.idle_gaps(reading, 0.0, 110.0, "harness")
    assert [n for n, _ in got] == ["decode", "decode", "prefill"]


def test_the_breakdown_keeps_the_device_operations():
    reading = _with_program(_parent_reading())
    got = program.breakdown(reading, "harness")
    assert got["device_ops"] == trace.breakdown(
        _parent_reading(), "harness")["device_ops"]
    assert got["idle_gaps"][0] == ["serve.decode_step", 40.0 / 1e6]


def test_innermost_sweeps_nested_spans():
    spans = [("a", 0.0, 100.0), ("b", 10.0, 40.0), ("c", 20.0, 30.0),
             ("d", 50.0, 60.0), ("e", 70.0, 71.0)]
    gaps = [(21.0, 29.0), (35.0, 45.0), (11.0, 39.0), (55.0, 75.0),
            (101.0, 102.0)]
    gaps.sort()
    assert program._innermost(spans, gaps) == [
        "b", "c", "a", "a", None]


# each reader on the synthetic reading: the decode step (5-105) holds the
# main thread's waits at 11 and 40 (5 us of 100)
KNOWN = {
    "host_syncs.decode": 2.0,
    "launch_ms.decode": (100.0 - 5.0) / 1e3,
}


@pytest.mark.parametrize("name", sorted(program.READERS))
def test_every_reader_reads_none_on_the_parents_reading(name):
    assert program.READERS[name]({"trace": _parent_reading()}) is None
    assert program.READERS[name]({}) is None


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_the_decode_readers_read_known_values(name):
    ctx = {"trace": _with_program(_parent_reading())}
    assert program.READERS[name](ctx) == pytest.approx(KNOWN[name])


def _training_reading():
    """Two steps on the main thread, each a to_device and loss read with a
    wait, an optimizer of 30 and 34 device us, a pipeline wait of 2 and 4
    us; a step of another thread's is not counted."""
    prog = []
    waits = []
    for i, t0 in enumerate((0.0, 200.0)):
        prog += [("pipeline.wait", t0, t0 + 2.0 + 2 * i, MAIN, 0.0),
                 ("train.step", t0 + 10, t0 + 190, MAIN, 900.0),
                 ("train.optimizer", t0 + 150, t0 + 170, MAIN, 30.0 + 4 * i)]
        waits += [("cudaStreamSynchronize", t0 + 11, t0 + 12, MAIN),
                  ("cudaStreamSynchronize", t0 + 180, t0 + 185, MAIN)]
    prog.append(("train.step", 0.0, 400.0, OTHER, 0.0))
    waits.append(("cudaStreamSynchronize", 300.0, 301.0, OTHER))
    prog.sort(key=lambda s: (s[1], -s[2]))
    return dict(_parent_reading(), program=prog, waits=waits,
                main_thread=MAIN)


@pytest.mark.parametrize("name,want", [
    ("host_syncs.train", 2.0),
    ("adamw_ms.train", 32.0 / 1e3),
    ("input_wait_ms.train", 3.0 / 1e3),
])
def test_the_training_readers_read_known_values(name, want):
    got = program.READERS[name]({"trace": _training_reading()})
    assert got == pytest.approx(want)


def test_the_decode_readers_read_none_on_a_training_reading():
    ctx = {"trace": _training_reading()}
    assert program.READERS["host_syncs.decode"](ctx) is None
    assert program.READERS["launch_ms.decode"](ctx) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("program"))


def _profiled(root, cell):
    import time

    from h100bench import core, with_spans
    return with_spans.profile_cell(core.Bench(root), cell, 2 ** 31 + 7, 0.3,
                                   "cpu", time.perf_counter())


def test_a_tiny_serving_run_reads_the_programs_spans(root):
    line = _profiled(root, "llama-tiny.serve-tiny")
    assert line["correct"]
    new = _tiny.TINY_MIXES["serve-tiny"]["new_tokens"]
    layers = _tiny.TINY_CONFIGS["llama-tiny"]["num_layers"]
    assert line["spans"]["serve.decode_step"][0] == new
    assert line["spans"]["attention.cache"][0] == new * layers
    assert line["spans"]["serve.prefill"][0] == 1
    # no card: no blocking runtime call to count
    assert line["metrics"]["host_syncs.decode"] == 0.0
    assert line["metrics"]["launch_ms.decode"] > 0.0
    assert "host_syncs.train" not in line["metrics"]


def test_a_tiny_training_run_reads_the_programs_spans(root):
    from h100bench.drivers import train
    line = _profiled(root, "rwkv6-tiny.train-tiny")
    assert line["correct"]
    assert line["spans"]["train.step"][0] == train.TRACED_STEPS
    assert line["spans"]["train.optimizer"][0] == train.TRACED_STEPS
    assert line["spans"]["pipeline.wait"][0] == train.TRACED_STEPS
    for name in ("host_syncs.train", "adamw_ms.train", "input_wait_ms.train"):
        assert name in line["metrics"]
    assert "host_syncs.decode" not in line["metrics"]


def test_the_programs_spans_stay_out_of_the_harness_reading():
    """``trace.read`` reads the same with the program's ranges recorded:
    they are neither device operations nor harness spans; ``read`` finds
    them, on the marks' thread."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.spans import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.mark()
        with trace.span("call"), span("serve.decode_step"):
            with span("layer.mix"):
                pass
        trace.mark()
    plain = trace.read(prof)
    assert set(plain["spans"]) == {"call"} and plain["ops"] == []
    got = program.read(prof)
    assert [s[0] for s in got["program"]] == ["serve.decode_step",
                                              "layer.mix"]
    assert {s[3] for s in got["program"]} == {got["main_thread"]}
    assert got["waits"] == []
