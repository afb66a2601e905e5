"""``BENCHMARK.json`` against the benchmark's contract, and the harness
taking a new configuration, mix, cell and per-layer metric as new files."""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _tiny  # noqa: E402

ROOT = _tiny.REPO
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w)
                                              for w in SPEC["command"])
    assert SPEC["command"][1].startswith("h100bench/")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines_use_the_allowed_characters(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", ()):
            assert NAME.match(key), key


def test_every_entry_has_just_its_keys_and_its_files():
    home = ROOT / "h100bench"
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (home / "reference" / f"{cfg['architecture']}.py").is_file()
        assert (home / "counts" / f"{cfg['architecture']}.py").is_file()
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((home / "mixes" / f"{w['traffic']}.json").read_text())
        assert (home / "drivers" / f"{mix['kind']}.py").is_file()
        assert (home / "limits" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"], m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (home / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        has = [m for m in SPEC["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(has) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


# keys that hold a width (a hidden, intermediate, low-rank, head or
# vocabulary size), which a configuration never cuts
WIDTHS = re.compile(r"(^d_model$|^d_ff$|_dim$|_rank$|^rwkv_lora_|"
                    r"^vocab_size$|^num_heads$|^num_kv_heads$)")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_a_configuration_differs_from_its_source_only_where_reduced(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    published = {k: v for k, v in cfg.get("published", {}).items()
                 if k in cfg}
    changed = {k for k, v in published.items() if cfg[k] != v}
    assert changed == set(entry["reduced"])
    assert not any(WIDTHS.search(k) for k in entry["reduced"])


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def _digests(home: Path) -> dict:
    return {str(p.relative_to(home)): hashlib.sha256(p.read_bytes()).digest()
            for p in home.rglob("*") if p.is_file()}


def test_a_new_configuration_mix_cell_and_metric_are_new_files(tmp_path):
    """A later change adds a configuration, a mix, a cell and a per-layer
    metric by adding files and entries: the harness takes them up with no
    file it already had edited."""
    root = _tiny.make_root(tmp_path)
    home = root / "h100bench"
    before = _digests(home)
    cfg = dict(_tiny.TINY_CONFIGS["rwkv6-tiny"], name="rwkv6-wide",
               d_model=192)
    (home / "configs" / "rwkv6-wide.json").write_text(json.dumps(cfg))
    (home / "mixes" / "train-long.json").write_text(json.dumps(
        dict(_tiny.TINY_MIXES["train-tiny"], seq_len=64)))
    (home / "limits" / "rwkv6-wide.train-long.json").write_text(
        (home / "limits" / "rwkv6-tiny.train-tiny.json").read_text())
    (home / "metrics" / "tokens_per_step.train.py").write_text(
        "def read(ctx):\n    return float(ctx['tokens_per_step'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rwkv6-wide", "source": cfg["source"],
                            "file": "h100bench/configs/rwkv6-wide.json",
                            "reduced": [], "why": "wider"})
    spec["workloads"].append({"name": "rwkv6-wide.train-long",
                              "config": "rwkv6-wide",
                              "traffic": "train-long", "chips": 1,
                              "why": "longer rows"})
    for m in spec["end_to_end"]:
        if "rwkv6-tiny.train-tiny" in m.get("workloads", ()):
            m["workloads"].append("rwkv6-wide.train-long")
    spec["per_layer"].append({
        "name": "tokens_per_step.train", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "input pipeline",
        "moves": "train_tokens_per_s",
        "workloads": ["rwkv6-wide.train-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    line = _tiny.run(root, "rwkv6-wide.train-long", trace=True)
    assert line["metrics"]["tokens_per_step.train"]["value"] == 4 * 64
    assert "input_ms.train" not in line["metrics"]
    plain = _tiny.run(root, "rwkv6-wide.train-long")
    assert set(plain["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                     "setup_s"}
    assert plain["correct"], plain["checks"]
    after = _digests(home)
    assert all(after[name] == digest for name, digest in before.items())
