"""The reference's dry-run numbers for a list of cells: the JAX package's
own ``lower_cell`` (src/repro/launch/dryrun.py), compiled on a 16x16 mesh
of 256 forced host devices, each cell cut to one layer group, as the
port's ``lower_cell(..., groups=1)`` counts it.

The reference's CLI cannot do this on jax 0.9: ``jax.make_mesh``
(src/repro/launch/mesh.py) gives Explicit axes, which its
``with_sharding_constraint`` calls refuse.  Three substitutions, made at
run time in this process and in no file of the package, get round it:

* ``XLA_FLAGS=--xla_force_host_platform_device_count=256`` before jax
  starts its backend;
* ``make_production_mesh`` is a ``Mesh`` of the first 256 devices, shaped
  (16, 16) with axes ("data", "model"), whose axes are Auto;
* ``get_config`` returns the config cut to one layer group
  (``n_layers = len(pattern)``, at most one encoder layer), the
  counterpart of the port's ``--groups 1``.

Run it as its own process (the device count is fixed when jax starts):

    PYTHONPATH=src python tests/dryrun_ref_oracle.py OUT.json CELLS [REGEX]

``CELLS`` is a JSON list of ``[arch, shape]`` pairs, or ``all`` for every
supported cell.  OUT.json maps ``"arch|shape"`` to the roofline's counts
and ``compile_seconds``, or to ``{"error": ...}``; it is written after
every cell.  With ``REGEX`` the lines of each cell's compiled HLO that
match it are printed (as tools/hlo_grep.py prints them).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

DEVICES = jax.devices()  # starts the backend at 256 devices

from repro.launch import dryrun  # noqa: E402  (its own XLA_FLAGS come late)
from repro.models.registry import all_cells, cell_supported  # noqa: E402

KEEP = ("flops", "memory_bytes", "collective_bytes", "collective_by_kind",
        "dominant", "compute_s", "memory_s", "collective_s")


def _auto_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        raise ValueError("the oracle compiles the 16x16 mesh only")
    return Mesh(np.asarray(DEVICES[:256]).reshape(16, 16), ("data", "model"))


def _one_group(get_config):
    def cut(arch):
        cfg = get_config(arch)
        return dataclasses.replace(
            cfg, n_layers=len(cfg.pattern),
            n_encoder_layers=min(cfg.n_encoder_layers, 1))
    return cut


def _grep_hlo(pattern: str) -> None:
    report = dryrun.roofline_report

    def grep(**kw):
        for line in kw["hlo_text"].splitlines():
            if re.search(pattern, line):
                print("   ", line.strip()[:300])
        return report(**kw)

    dryrun.roofline_report = grep


def main(out_path: str, cells_arg: str, pattern: str | None = None) -> None:
    dryrun.make_production_mesh = _auto_mesh
    dryrun.get_config = _one_group(dryrun.get_config)
    if pattern:
        _grep_hlo(pattern)
    cells = ([c for c in all_cells() if cell_supported(*c)[0]]
             if cells_arg == "all" else [tuple(c) for c in json.loads(cells_arg)])
    out: dict = {}
    for arch, shape in cells:
        t0 = time.perf_counter()
        try:
            r = dryrun.lower_cell(arch, shape, multi_pod=False)
            roof = r["roofline"]
            out[f"{arch}|{shape}"] = {
                **{k: roof[k] for k in KEEP},
                "compile_seconds": r["compile_seconds"],
                "seconds": time.perf_counter() - t0,
            }
        except Exception as e:  # noqa: BLE001 (recorded per cell)
            out[f"{arch}|{shape}"] = {"error": f"{type(e).__name__}: {e}"[:2000]}
        print(f"{arch}|{shape} {time.perf_counter() - t0:.1f}s", flush=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(*sys.argv[1:4])
