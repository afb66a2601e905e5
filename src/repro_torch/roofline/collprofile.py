"""Collective profile of HLO text: which collective ops, of which shapes,
account for the collective bytes (the reference's
``repro.roofline.collprofile``).

``profile_text`` parses HLO text as the reference's does.  A PyTorch step
has no HLO, so the port has no module to profile: ``main`` says so and
exits non-zero rather than print an empty profile.

Usage:
    python -m repro_torch.roofline.collprofile --arch qwen2-72b --shape train_4k
"""

import argparse
import collections
import sys

from repro_torch.roofline.analysis import _OP_RE, _shape_bytes

REASON = ("no collective profile: a PyTorch step has no HLO, so the port "
          "counts no collective; the dry run's collective terms are null")


def profile_text(hlo_text: str, top: int = 20):
    agg = collections.Counter()
    cnt = collections.Counter()
    for m in _OP_RE.finditer(hlo_text):
        shape_token, kind, suffix = m.group(1), m.group(2), m.group(3)
        if suffix == "-done":
            continue
        key = (kind, shape_token.split("{")[0])
        agg[key] += _shape_bytes(shape_token)
        cnt[key] += 1
    return [(kind, shape, bts, cnt[(kind, shape)])
            for (kind, shape), bts in agg.most_common(top)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mcfg", action="append", default=[])
    ap.add_argument("--tcfg", action="append", default=[])
    args = ap.parse_args(argv)
    print(f"{args.arch} {args.shape}: {REASON}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
