"""Aggregate the dry run's JSON cells into tables (the reference's
``repro.roofline.report``).  A term the port does not measure (the
collective ones) is ``null`` in a cell and ``n/a`` in a table.

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.roofline import hw


def load_cells(directory: str):
    cells = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        d["_file"] = os.path.basename(f)
        cells.append(d)
    return cells


def fmt_gib(b):
    return f"{b / 2**30:.2f}"


def _num(v, fmt: str) -> str:
    """``v`` formatted, or ``n/a`` where it was not measured."""
    return "n/a" if v is None else format(v, fmt)


def dryrun_table(cells) -> str:
    hbm = f"{hw.HBM_BYTES / 2**30:.1f}GiB"
    out = ["| arch | shape | mesh | status | compile_s | peak GiB/dev | "
           f"fits {hbm} | coll ops |",
           "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("status") == "skipped":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                       f"skipped¹ | — | — | — | — |")
            continue
        mem = d.get("memory", {})
        vc = d.get("validation_cost", {})
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['status']} | "
            f"{d.get('compile_s', 0):.1f} | "
            f"{fmt_gib(mem.get('peak_bytes', 0))} | "
            f"{'✓' if d.get('fits_hbm') else '✗²'} | "
            f"{_num(vc.get('coll_ops'), '.0f')} |")
    return "\n".join(out)


def _move_down_note(d) -> str:
    """One sentence: what would move the dominant term down."""
    r = d["roofline"]
    dom = r["dominant"]
    arch, shape = d["arch"], d["shape"]
    moe = arch in ("arctic-480b", "deepseek-moe-16b")
    if dom == "collective":
        if shape == "train_4k":
            return ("cut table/weight all-gathers (vocab layout) and "
                    "amortize FSDP gathers over bigger microbatches")
        return ("overlap the per-layer TP all-reduces with the next "
                "layer's matmuls (async collectives)")
    if dom == "memory":
        if shape.startswith(("decode", "long")):
            return "quantize the KV cache (int8 halves the cache read)"
        return "fuse residual streams; drop activation dtype to bf16"
    if moe:
        return "slot-scatter dispatch removes the quadratic one-hot MACs"
    return "raise arithmetic intensity: larger per-device microbatch"


def roofline_table(cells) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "dominant | MODEL_FLOPS/counted | what moves the dominant term "
           "down |",
           "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("mesh") != "single" or "roofline" not in d:
            continue
        r = d["roofline"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {_num(r['collective_s'], '.4f')} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{_move_down_note(d)} |")
    return "\n".join(out)


def perf_table(cells) -> str:
    out = ["| cell | variant | compute_s | memory_s | collective_s | "
           "dominant | Δ dominant |",
           "|---|---|---|---|---|---|---|"]
    by_cell = {}
    for d in cells:
        if "roofline" not in d:
            continue
        key = (d["arch"], d["shape"])
        by_cell.setdefault(key, []).append(d)
    for key, ds in by_cell.items():
        base = None
        for d in sorted(ds, key=lambda x: x["_file"]):
            r = d["roofline"]
            tag = d["_file"].rsplit(".json", 1)[0]
            tag = tag.split("_single_")[-1] if "_single_" in tag else "baseline"
            dom_val = {"compute": r["compute_s"], "memory": r["memory_s"],
                       "collective": r["collective_s"]}[r["dominant"]]
            if base is None:
                base = dom_val
                delta = "—"
            else:
                delta = f"{(dom_val / base - 1) * 100:+.1f}%"
            out.append(
                f"| {key[0]} {key[1]} | {tag} | {r['compute_s']:.3f} | "
                f"{r['memory_s']:.3f} | {_num(r['collective_s'], '.3f')} | "
                f"{r['dominant']} | {delta} |")
    return "\n".join(out)


def main():
    directory = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    cells = load_cells(directory)
    mode = sys.argv[2] if len(sys.argv) > 2 else "all"
    if mode in ("all", "dryrun"):
        print("### Dry-run table\n")
        print(dryrun_table(cells))
        print()
    if mode in ("all", "roofline"):
        print("### Roofline table (single-pod)\n")
        print(roofline_table(cells))
        print()
    if mode in ("all", "perf"):
        print("### Perf variants\n")
        print(perf_table(cells))


if __name__ == "__main__":
    main()
