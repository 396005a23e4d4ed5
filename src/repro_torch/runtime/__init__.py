"""Runtime services of the port: the fault plans (runtime/faults.py)."""
from repro_torch.runtime import faults

__all__ = ["faults"]
