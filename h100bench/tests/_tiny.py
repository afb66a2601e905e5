"""A benchmark root at a size a CPU test can hold: a temporary directory
with its own ``BENCHMARK.json``, the benchmark's code folders copied, and
tiny configurations, mixes and limits of the two cells' kinds beside the
real ones.  The port runs its kernels' plain versions there."""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # h100bench/
REPO = HERE.parent

TINY_CONFIGS = {
    "rwkv6-tiny": dict(
        json.loads((HERE / "configs" / "rwkv6-7b.json").read_text()),
        name="rwkv6-tiny", num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, rwkv_lora_decay=8, rwkv_lora_mix=8, chunk_len=16,
        microbatch_tokens_per_device=32, dtype="float32"),
    "llama-tiny": dict(
        json.loads((HERE / "configs" / "deepseek-7b.json").read_text()),
        name="llama-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=1024,
        dtype="float32"),
}
TINY_CONFIGS["rwkv6-tiny"]["train"] = dict(
    TINY_CONFIGS["rwkv6-tiny"]["train"], learning_rate=1e-2)
TINY_MIXES = {
    "train-tiny": {"kind": "train", "batch": 4, "seq_len": 32,
                   "corpus": {"tokens": 8192, "shard_tokens": 1024,
                              "exponent": 1.0}},
    "serve-tiny": {"kind": "serve_batch", "batch": 4, "prompt_len": 16,
                   "new_tokens": 24, "checked": 4},
}
TINY_CELLS = {
    "rwkv6-tiny.train-tiny": ("rwkv6-tiny", "train-tiny"),
    "llama-tiny.serve-tiny": ("llama-tiny", "serve-tiny"),
}
# limits of the tiny cells (both fp32, so that the port's plain versions
# and the references compute one function), set as the real cells' are:
# from the sound runs' readings at this size (training 1e-7 to 1e-5, the
# serving cell's widest gap under 1e-5) and the controls'
# (test_h100bench_controls.py: the head's gradient direction reads 0.1 and
# more in fp8 and with half the batch, fp8 serving's gap 0.01 and more)
# the numbers compared are the real cells' (an exact count keeps its 0)
TINY_LIMITS = {
    tiny: {name: (0 if limit == 0 else 1e-3) for name, limit in json.loads(
        (HERE / "limits" / f"{real}.json").read_text()).items()}
    for tiny, real in (("rwkv6-tiny.train-tiny", "rwkv6-7b.train-4k"),
                       ("llama-tiny.serve-tiny", "deepseek-7b.serve-4k"))}
REAL_CELL = {"rwkv6-tiny.train-tiny": "rwkv6-7b.train-4k",
             "llama-tiny.serve-tiny": "deepseek-7b.serve-4k"}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp`` holding the tiny cells (and the real
    ones, as ``BENCHMARK.json`` names them)."""
    root = Path(tmp) / "bench"
    home = root / "h100bench"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    for name, cfg in TINY_CONFIGS.items():
        (home / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"h100bench/configs/{name}.json",
                                "reduced": [], "why": "tiny"})
    for name, mix in TINY_MIXES.items():
        (home / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (cfg, mix) in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": mix, "chips": 1, "why": "tiny"})
        (home / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS[cell]))
        real = REAL_CELL[cell]
        for section in ("end_to_end", "per_layer"):
            for m in spec[section]:
                if real in m.get("workloads", ()):
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root: Path, cell: str, seed: int = 12345, trace: bool = False,
        seconds: float = 0.3):
    from h100bench import core
    return core.run_cell(core.Bench(root), cell, seed, seconds, trace, "cpu",
                         time.perf_counter())
