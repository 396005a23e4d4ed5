"""Runtime services of the port: the fault plans (runtime/faults.py), the
tracer (runtime/trace.py), the step monitor (runtime/heartbeat.py), the
training supervisor (runtime/supervisor.py) and elastic re-meshing
(runtime/elastic.py)."""
from repro_torch.runtime import faults, trace

__all__ = ["faults", "trace"]
