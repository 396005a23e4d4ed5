"""EngineConfig: the one frozen value that fully describes an Engine.

Everything an :class:`~repro_torch.vortex.Engine` session needs — target
hardware, compute backends, device and executable implementation — lives
here, so engines are reproducible from a single hashable value.  The
analyzer's empirical levels, Eq. 3's level-2 unit count and the
selection-table sizing follow from the hardware, as the reference's
defaults do.  The profiler is the one
deliberate exception (a live object; pass it to ``Engine`` directly).
"""
from __future__ import annotations

import dataclasses

from repro_torch.device import resolve_device, resolve_impl

__all__ = ["EngineConfig"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen description of one engine session.

    * ``hardware`` — a :func:`repro_torch.core.hardware.get_hardware` name;
      the lattice is generated for THIS target (``h100_sxm`` by default;
      the CPU parity tests use ``tpu_v5e`` so buckets and tiles compare
      one for one with the JAX package).
    * ``backends`` — compute backends to score (None = all the hardware
      declares; the selector picks per shape, Fig. 16).
    * ``device`` — where the executables run: ``"cuda"`` (default; raises
      without a GPU) or ``"cpu"``.
    * ``impl`` — ``"cuda"`` (the hand-written kernels) or ``"torch"``
      (their plain versions); None resolves to ``"cuda"`` on the card and
      ``"torch"`` on the CPU.  Counterparts of the reference's ``"pallas"``
      and ``"xla"``.
    """

    hardware: str = "h100_sxm"
    backends: tuple[str, ...] | None = None
    device: str = "cuda"
    impl: str | None = None

    def __post_init__(self) -> None:
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", str(dev))
        object.__setattr__(self, "impl", resolve_impl(dev, self.impl))
        if self.backends is not None:
            object.__setattr__(self, "backends", tuple(self.backends))
