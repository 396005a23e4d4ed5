"""Find a cell and everything that belongs to it by name.

BENCHMARK.json names the cell, its configuration and its traffic; the
files are ``perfbench/configs/<config>.json``,
``perfbench/traffic/<traffic>.json``, ``perfbench/cells/<cell>.json``
(server settings, traced-slice length, how many tokens to compare, the
limits) and one reader ``perfbench/metrics/<metric>.py`` per metric.  A
metric applies to the cells its ``workloads`` list names, or to every
cell without one.  A reader that reads the port's own records says so
with ``PROGRAM_TRACE = True``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict
    mix: dict
    settings: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = _json(os.path.join(HERE, "configs", w["config"] + ".json"))
    mix = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    settings = _json(os.path.join(HERE, "cells", name + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), conf=conf, mix=mix,
        settings=settings,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def _module(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pbmetric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` of ``perfbench/metrics/<metric>.py``."""
    return _module(metric).read


def wants_program(cell: Cell, traced: bool) -> bool:
    """Whether the run turns the port's tracer on: a traced run of a cell
    one of whose per-layer readers sets ``PROGRAM_TRACE = True``
    (``kit/program_trace.py``)."""
    return traced and any(getattr(_module(m["name"]), "PROGRAM_TRACE",
                                  False) for m in cell.per_layer)
