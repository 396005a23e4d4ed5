#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
BENCHMARK.json; its configuration (``perfbench/configs/<config>.json``),
traffic (``perfbench/traffic/<traffic>.json``), server settings and
limits (``perfbench/cells/<cell>.json``) and each metric's reader
(``perfbench/metrics/<metric>.py``) are found by name.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a traced slice of the window.  The last line of standard
output is one JSON object; the numbers compared for ``correct`` are the
last lines of standard error and the result's last key.

Options for measuring the benchmark itself, never passed by a check:
``--rate`` overrides an open-loop mix's rate (the knee sweep),
``--control 1`` puts the comparison's control in the program's place:
its readings are judged, so ``correct`` must come out false, and the
program's are printed beside them (``program_correct``), and
``--dump <file>`` writes the run's spans as JSON.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = os.path.join(ROOT, ".perfbench_cache")


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("VORTEX_CACHE_DIR", "vortex")):
        os.environ[var] = os.path.join(CACHE, sub)


def loaded_forbidden() -> list[str]:
    """Modules whose whole top-level name is the JAX stack or the JAX
    package (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    _cache_env()
    sys.path.insert(0, HERE)
    from kit import spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path.insert(1, src)
    from kit import runner

    result = runner.run(cell, args, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in result.pop("notes"):
        print(line)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
