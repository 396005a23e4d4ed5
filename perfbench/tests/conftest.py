"""perfbench's own tests: ``PYTHONPATH=src python -m pytest perfbench/tests``
from the repository's root.  The harness's modules (``kit``,
``reference``) are imported from perfbench/, the program from src/."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
for p in (PB, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip where there is no CUDA device (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
