"""The port's dry-run counts (launch/dryrun.py) held cell by cell against
the reference's, both on a 16x16 mesh at one layer group:

* the reference: its own ``lower_cell`` compiled on 256 forced host
  devices by ``tests/dryrun_ref_oracle.py`` (an Auto-axis mesh and a
  one-group config substituted at run time; nothing in src/repro/ is
  edited);
* the port: ``lower_cell(..., groups=1)`` on a fake 256-rank world.

Both run at once, in subprocesses of their own, each under a 300 s
limit; the port's ten cells are split over six of them.  One cell for
each fault the dry run had (ROADMAP C16-C20):

* C16, gemma2-9b ``decode_32k``: the vocabulary-sharded table is not
  gathered whole (all-gather under 1% of its 1,835,008,000 bytes), the
  collective bytes are within 2x of the reference's and the dominant
  term is the reference's;
* C17, h2o-danube-3-4b ``train_4k``; C18, phi4-mini-3.8b ``train_4k``
  and whisper-small ``prefill_32k``; C19, deepseek-v2-236b
  ``decode_32k``: counted with no error;
* C17, C19 and C20 (gemma2-9b ``prefill_32k``): FLOPs a device within
  0.67-1.5x of the reference's for the same work.  The reference's
  prefill projects every row onto the vocabulary and keeps the last; the
  port projects the last row only.  Those rows' FLOPs are taken out of
  the reference's count before the prefill is compared, and a test pins
  that they are the whole of the prefill's difference.

and cells for the two Mamba faults (ROADMAP C21, C22):

* C21, falcon-mamba-7b and jamba-v0.1-52b ``prefill_32k`` and
  falcon-mamba-7b ``train_4k``: Mamba's conv and scan on each rank's own
  channels.  FLOPs a device within 0.67-1.5x of the reference's same
  work, and collective bytes within 2x of the reference's, 4.15x in the
  train cell (the worst non-Mamba train cell's ratio, phi4-mini-3.8b's:
  train cells gather each sublayer's sequence where GSPMD moves
  activations);
* C22, jamba-v0.1-52b ``long_500k``: a decode leaves its FSDP expert
  stacks sharded.  Collective bytes within 2x of the reference's, and
  neither side all-gathers 1% of one expert's bf16 matrix.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.models.config import SHAPES
from repro_torch.models.registry import get_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = {
    "C16": ("gemma2-9b", "decode_32k"),
    "C17": ("h2o-danube-3-4b", "train_4k"),
    "C18a": ("phi4-mini-3.8b", "train_4k"),
    "C18b": ("whisper-small", "prefill_32k"),
    "C19": ("deepseek-v2-236b", "decode_32k"),
    "C20": ("gemma2-9b", "prefill_32k"),
    "C21a": ("falcon-mamba-7b", "prefill_32k"),
    "C21b": ("jamba-v0.1-52b", "prefill_32k"),
    "C21c": ("falcon-mamba-7b", "train_4k"),
    "C22": ("jamba-v0.1-52b", "long_500k"),
}
# The port's cells per subprocess, counted without the memory tracker's
# run: the train cells and jamba's prefill (seven Mamba scans) take most
# of the time, so each leads a process of its own.
PORT_JOBS = (("C17", "C19"), ("C18a", "C16"), ("C20", "C18b"), ("C21c",),
             ("C21b",), ("C21a", "C22"))
MODEL_AXIS = 16
TABLE_BYTES = 256000 * 3584 * 2  # gemma2-9b's embedding table, bf16
STACK_BYTES = 4096 * 14336 * 2  # one of jamba's expert matrices, bf16

_PORT = textwrap.dedent(
    """
    import json, sys
    from repro_torch.launch.dryrun import lower_cell
    out = {}
    for arch, shape in json.loads(sys.argv[2]):
        try:
            r = lower_cell(arch, shape, multi_pod=False, groups=1,
                           memory=False)
            out[arch + "|" + shape] = r["roofline"]
        except Exception as e:  # recorded per cell
            out[arch + "|" + shape] = {"error": f"{type(e).__name__}: {e}"}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    jobs = [[str(ROOT / "tests" / "dryrun_ref_oracle.py"),
             str(tmp / "ref.json"), json.dumps(list(CELLS.values()))]]
    for i, names in enumerate(PORT_JOBS):
        jobs.append(["-c", _PORT, str(tmp / f"port{i}.json"),
                     json.dumps([CELLS[n] for n in names])])
    procs = [subprocess.Popen([sys.executable, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(ROOT), env=env)
             for args in jobs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    port: dict = {}
    for i in range(len(PORT_JOBS)):
        with open(tmp / f"port{i}.json") as f:
            port.update(json.load(f))
    with open(tmp / "ref.json") as f:
        ref = json.load(f)
    return {"port": port, "ref": ref}


def _get(runs, side, fault):
    return runs[side]["|".join(CELLS[fault])]


def _unprojected_head_flops(arch, shape_name):
    """The FLOPs of the rows a prefill projects onto the vocabulary in the
    reference and not in the port: all but the last, on one device (the
    batch over 16 data ranks, the vocabulary over 16 model ranks)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rows = shape.global_batch // 16 * (shape.seq_len - 1)
    return 2 * rows * cfg.d_model * cfg.vocab_padded // MODEL_AXIS


@pytest.mark.parametrize("side", ["port", "ref"])
@pytest.mark.parametrize("fault", CELLS)
def test_cell_is_counted_on_both_sides(runs, fault, side):
    r = _get(runs, side, fault)
    assert "error" not in r, r
    for k in ("flops", "memory_bytes", "collective_bytes"):
        assert r[k] > 0, (k, r[k])
    assert r["dominant"] in ("compute", "memory", "collective")


def test_c16_decode_gathers_no_embedding_table(runs):
    port, ref = _get(runs, "port", "C16"), _get(runs, "ref", "C16")
    assert port["collective_by_kind"].get("all-gather", 0) < 0.01 * TABLE_BYTES
    assert port["collective_bytes"] <= 2 * ref["collective_bytes"]
    assert ref["collective_bytes"] <= 2 * port["collective_bytes"]
    assert port["dominant"] == ref["dominant"]


def test_c16_reference_gathers_no_embedding_table(runs):
    # GSPMD partitions the reference's jnp.take over the sharded table.
    ref = _get(runs, "ref", "C16")
    assert ref["collective_by_kind"].get("all-gather", 0) < 0.01 * TABLE_BYTES
    assert ref["dominant"] == "memory"


@pytest.mark.parametrize("fault", ["C17", "C19", "C20"])
def test_flops_a_device_match_the_reference(runs, fault):
    port, ref = _get(runs, "port", fault), _get(runs, "ref", fault)
    arch, shape = CELLS[fault]
    same_work = ref["flops"]
    if SHAPES[shape].kind == "prefill":
        same_work -= _unprojected_head_flops(arch, shape)
    assert 0.67 <= port["flops"] / same_work <= 1.5, (
        port["flops"], ref["flops"], same_work)


def test_c20_prefill_differs_from_the_reference_by_its_head_rows(runs):
    # The reference's prefill projects all 65,536 rows of a device onto
    # its 16,000 vocabulary columns (a dot f32[65536,16000]) and keeps
    # the last; the port's projects the last row: that is the whole of
    # the difference, to 1% of the count.
    port, ref = _get(runs, "port", "C20"), _get(runs, "ref", "C20")
    head = _unprojected_head_flops(*CELLS["C20"])
    assert abs(ref["flops"] - head - port["flops"]) < 0.01 * port["flops"]


@pytest.mark.parametrize("fault", ["C21a", "C21b", "C21c"])
def test_c21_mamba_flops_a_device_match_the_reference(runs, fault):
    port, ref = _get(runs, "port", fault), _get(runs, "ref", fault)
    arch, shape = CELLS[fault]
    same_work = ref["flops"]
    if SHAPES[shape].kind == "prefill":
        same_work -= _unprojected_head_flops(arch, shape)
    assert 0.67 <= port["flops"] / same_work <= 1.5, (
        port["flops"], ref["flops"], same_work)


@pytest.mark.parametrize("fault", ["C21a", "C21b", "C21c"])
def test_c21_mamba_collectives_within_bound(runs, fault):
    # Each rank keeps its own channels: the conv's input is not gathered
    # whole (ROADMAP C21: 9.66x the reference's bytes in falcon's prefill,
    # 7.05x in jamba's, 7.7x in falcon's train cell).
    port, ref = _get(runs, "port", fault), _get(runs, "ref", fault)
    bound = 4.15 if SHAPES[CELLS[fault][1]].kind == "train" else 2
    assert port["collective_bytes"] <= bound * ref["collective_bytes"], (
        port["collective_by_kind"], ref["collective_by_kind"])


def test_c21_falcon_prefill_differs_from_the_reference_by_its_head_rows(
        runs):
    # falcon-mamba has no attention: less the head rows the two prefills
    # count the same products, to 1%.
    port, ref = _get(runs, "port", "C21a"), _get(runs, "ref", "C21a")
    head = _unprojected_head_flops(*CELLS["C21a"])
    assert abs(ref["flops"] - head - port["flops"]) < 0.01 * port["flops"]


def test_c22_long_decode_gathers_no_expert_stack(runs):
    port, ref = _get(runs, "port", "C22"), _get(runs, "ref", "C22")
    assert port["collective_by_kind"].get("all-gather", 0) < 0.01 * STACK_BYTES
    assert port["collective_bytes"] <= 2 * ref["collective_bytes"], (
        port["collective_by_kind"], ref["collective_by_kind"])


def test_c22_reference_gathers_no_expert_stack(runs):
    # GSPMD all-reduces the decode's partial activations over "data".
    ref = _get(runs, "ref", "C22")
    assert ref["collective_by_kind"].get("all-gather", 0) < 0.01 * STACK_BYTES
    assert ref["collective_by_kind"].get("all-reduce", 0) > 0
