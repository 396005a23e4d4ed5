"""Runtime services of the port: the fault plans (runtime/faults.py), the
step monitor (runtime/heartbeat.py) and the training supervisor
(runtime/supervisor.py)."""
from repro_torch.runtime import faults

__all__ = ["faults"]
