"""BENCHMARK.json keeps to the contract's character sets, and the harness
finds every configuration, traffic mix, cell file and metric reader by
name."""
import json
import os
import re

import pytest

from kit import spec

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_metric_keys_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert spec.applies(moved, cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if spec.applies(m, w["name"])]
        per = [m for m in bench["per_layer"] if spec.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.conf["name"] == w["config"]
        assert cell.mix["kind"] in ("open_loop", "closed_loop",
                                    "gemm_stream")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    files = {f[:-3] for f in os.listdir(os.path.join(PB, "metrics"))
             if f.endswith(".py")}
    declared = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert files == declared


def test_files_under_paths_are_named_from_name_characters():
    rx = re.compile(r"^[A-Za-z0-9_./-]+$")
    for base, _, files in os.walk(PB):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert rx.match(rel), rel
