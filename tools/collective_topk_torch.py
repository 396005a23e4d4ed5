"""Count one dry-run cell on a fake world and rank its collectives by
output bytes (counterpart of tools/collective_topk.py).  A Python loop
dispatches each collective once per iteration, so every instance is
listed as it ran; the reference's trip multiplier is 1 here.

    python tools/collective_topk_torch.py <arch> <shape> [topk] [multi] [--groups N]
"""
import argparse
import collections
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline.op_counts import OpCounter  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("topk", nargs="?", type=int, default=15)
    ap.add_argument("mesh", nargs="?", default="single",
                    choices=["single", "multi"])
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args(argv)

    counters = []

    class Capture(OpCounter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            counters.append(self)

    dryrun.OpCounter = Capture
    dryrun.lower_cell(args.arch, args.shape, multi_pod=args.mesh == "multi",
                      groups=args.groups)
    rows = collections.Counter()
    for kind, nbytes, op, shape in counters[0].collectives:
        rows[(kind, op, shape, nbytes)] += 1
    ranked = sorted(rows.items(), key=lambda kv: -kv[0][3] * kv[1])
    total = sum(k[3] * n for k, n in rows.items())
    print(f"total collective bytes/dev: {total / 1e9:.3f} GB over "
          f"{sum(rows.values())} op-instances")
    for (kind, op, shape, nbytes), n in ranked[:args.topk]:
        print(f"  {nbytes * n / 1e9:9.3f} GB  x{n:5d}  {kind:18s} "
              f"{shape[:60]:60s} [{op}]")


if __name__ == "__main__":
    main()
