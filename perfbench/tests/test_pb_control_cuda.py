"""On the card, at each cell's own size and load with a short window: the
control (the reference, or the stream's product, on float8 e4m3
operands) put in the program's place comes out not correct through the
harness's own verdict, while the program's numbers of the same run stay
within their limits.  Run on the chip with

    python -m pytest -q -p no:cacheprovider -m cuda perfbench/tests/test_pb_control_cuda.py

(every cell, three seeds each; about 8 minutes on one H100)."""
import json
import os
import subprocess
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
CELLS = ["phi4-mini-gemm-stream", "granite-moe-batch"]
SEEDS = [2147483911, 2147483912, 2147483913]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell, seed):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # The control fails at least one of the cell's numbers; the program
    # passes them all.
    assert res["correct"] is False, res["checks"]
    assert res["program_correct"] is True, out.stdout[-4000:]
