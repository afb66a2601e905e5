"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (read from a profiled part of
the window).  The last line of standard output is one JSON object; the
last lines of standard error name each compared number beside its limit.
Exits non-zero, printing no result, where no CUDA card is available, where
the cell asks for more cards than there are, or where a module of JAX or of
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches_in_checkout() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only the first run in a checkout builds.  (The port's own
    kernels build into ``build/kernels`` beside these.)"""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches_in_checkout()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from h100bench import core

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    bench = core.Bench(ROOT)
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device is available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    line = core.run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0)
    found = core.loaded_forbidden()
    if found:
        print(f"h100bench: the run loaded {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    core.print_checks(line)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
