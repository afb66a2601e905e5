"""Run chosen phases of a checkout's ``chip_smoke.py`` on the card, so that
two checkouts (a change and its parent, unpacked by ``git archive``) can be
timed in turns in one call:

    python3 chip_phases.py [--root DIR] PHASE [PHASE ...]

PHASE is ``3g`` (``flash_attention_bwd``'s windowed cases: each against
its plain version, ``LOCAL_BWD`` timed, split by kernel and set beside
SDPA's masked backward), ``3g-causal`` (its causal cases, the
``musicgen-medium`` and ``deepseek-7b`` shapes timed and split), ``3h``
(``rwkv6_chunked_bwd``'s cases against its plain version, ``RW_BWD_MAIN``
timed and split by pass), ``3i`` (``rglru_scan_bwd``'s cases against its
plain version, both forms timed at their main shapes, the gated entries'
instructions an element counted from the build's SASS), ``3j``
(``attention_decode_int8``'s cases against its plain version, the kernel
timed at ``deepseek-7b``'s decode beside its bound, the wrapper and the
plain version), ``16a``
(``recurrentgemma-2b`` trained whole:
step seconds, launches, device time by kind), ``16b`` (``rwkv6-7b`` at 8
layers, the same), ``16c`` (both recurrent models, one fp32 step on the
card against the CPU) or ``16c-rwkv`` (``rwkv6-7b``'s 16c gradients with
the kernels on the card, their plain versions on the card and on the
CPU, each pair's worst leaves).  Each phase runs the function of DIR's own
``chip_smoke.py`` (default: this checkout) on DIR's own ``src``, whose
kernels build into DIR's ``build/``; where DIR's phase 3h does not split
its kernel by pass, this checkout's split does, on DIR's kernel, and where
DIR's phase 3i counts no SASS, this checkout's count reads DIR's build.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time



def _here():
    """This checkout's ``chip_smoke.py`` (its helpers need no ``src``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rwkv6_bwd(cs, ops, ref):
    from repro_torch.kernels import rwkv6_scan

    out = cs.check_rwkv6_bwd_kernel(ops, ref, rwkv6_scan)
    if "split_ms" not in out:
        out["split_ms"] = _here().rwkv6_bwd_split(ops, rwkv6_scan)
        print(f"split by pass: {json.dumps(out['split_ms'])}", flush=True)
    return out


def _rglru_bwd(cs, ops, ref):
    from repro_torch.kernels import rglru_scan_bwd

    out = cs.check_rglru_bwd_kernel(ops, ref)
    if "sass" not in out:
        here = _here()
        out["sass"] = here.rglru_bwd_sass(rglru_scan_bwd.LIBRARY.info["path"])
        b, s, w = here.RG_BWD_MAIN
        for entry, got in sorted(out["sass"].items()):
            got["floor_ms"] = here._instr_floor_ms(b * s * w,
                                                   got["per_element"])
            print(f"  {entry}: {json.dumps(got)}", flush=True)
    return out


PHASES = {
    "3g": lambda cs, ops, ref: cs.check_windowed_flash_bwd(ops, ref),
    "3g-causal": lambda cs, ops, ref: cs.check_flash_bwd_kernel(ops, ref),
    "3h": _rwkv6_bwd,
    "3i": _rglru_bwd,
    "3j": lambda cs, ops, ref: cs.check_attention_decode_int8(ops, ref),
    "16a": lambda cs, ops, ref: cs.train_recurrent_whole(
        ops, "16a", "recurrentgemma-2b", 26),
    "16b": lambda cs, ops, ref: cs.train_recurrent_whole(
        ops, "16b", "rwkv6-7b", 8),
    "16c": lambda cs, ops, ref: cs.recurrent_card_against_cpu(),
    "16c-rwkv": lambda cs, ops, ref: cs.rwkv_gradients_three_ways(ops, ref),
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
