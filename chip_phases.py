"""Run chosen phases of a checkout's ``chip_smoke.py`` on the card, so that
two checkouts (a change and its parent, unpacked by ``git archive``) can be
timed in turns in one call:

    python3 chip_phases.py [--root DIR] PHASE [PHASE ...]

PHASE is ``3g`` (``flash_attention_bwd``'s windowed cases: each against
its plain version, ``LOCAL_BWD`` timed, split by kernel and set beside
SDPA's masked backward), ``3g-causal`` (its causal cases, the
``musicgen-medium`` and ``deepseek-7b`` shapes timed and split) or ``16a``
(``recurrentgemma-2b`` trained whole: step seconds, launches, device time
by kind).  Each phase runs the function
of DIR's own ``chip_smoke.py`` (default: this checkout) on DIR's own
``src``, whose kernels build into DIR's ``build/``.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PHASES = {
    "3g": lambda cs, ops, ref: cs.check_windowed_flash_bwd(ops, ref),
    "3g-causal": lambda cs, ops, ref: cs.check_flash_bwd_kernel(ops, ref),
    "16a": lambda cs, ops, ref: cs.train_recurrent_whole(
        ops, "16a", "recurrentgemma-2b", 26),
}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("phases", nargs="+", choices=sorted(PHASES))
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs._require_card()
    print(f"{root}: {cs._card_line()}", flush=True)
    from repro_torch.kernels import ops, ref

    for phase in args.phases:
        t0 = time.perf_counter()
        out = PHASES[phase](cs, ops, ref)
        print(f"{phase} of {root} in {time.perf_counter() - t0!r} s: "
              f"{json.dumps(out, default=str)}", flush=True)


if __name__ == "__main__":
    main()
