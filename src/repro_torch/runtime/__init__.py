"""Runtime services of the port: the fault plans (runtime/faults.py), the
step monitor (runtime/heartbeat.py), the training supervisor
(runtime/supervisor.py) and elastic re-meshing (runtime/elastic.py)."""
from repro_torch.runtime import faults

__all__ = ["faults"]
