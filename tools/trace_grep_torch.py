"""Count one dry-run cell on a fake world and grep the ops it dispatched
by name (counterpart of tools/hlo_grep.py, which greps the cell's HLO).
Each line is ``op(argument shapes) -> output shapes`` on this rank's
shards, in dispatch order.

    python tools/trace_grep_torch.py <arch> <shape> <regex> [max_lines] [--groups N]
"""
import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline.op_counts import OpCounter  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("pattern")
    ap.add_argument("max_lines", nargs="?", type=int, default=6)
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args(argv)

    counters = []

    class Tracing(OpCounter):
        def __init__(self, *a, **k):
            super().__init__(trace=True)
            counters.append(self)

    dryrun.OpCounter = Tracing
    dryrun.lower_cell(args.arch, args.shape, multi_pod=False,
                      groups=args.groups)
    n = 0
    for line in counters[0].trace:
        if re.search(args.pattern, line):
            print(line[:400])
            n += 1
            if n >= args.max_lines:
                break


if __name__ == "__main__":
    main()
