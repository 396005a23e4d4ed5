"""EngineConfig: the one frozen value that fully describes an Engine.

Everything an :class:`~repro_torch.vortex.Engine` session needs — target
hardware, compute backends, device, executable implementation,
selection-table sizing, precompile and staging policy — lives here, so
engines are reproducible from a single hashable value.  Eq. 3's level-2
unit count follows from the hardware.  The profiler is the one deliberate
exception (a live object; pass it to ``Engine`` directly).
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
    * ``empirical_levels`` — hierarchy levels the hybrid analyzer measures
      empirically (None = paper defaults, Table 7: level 0 on the host
      CPU, levels 0-1 on accelerator-class hardware; ``()`` = fully
      analytical).
    * ``table_m_max`` / ``table_extend_limit`` — initial coverage and
      doubling ceiling of the offline-materialized selection table
      (selection_table.py); 0 disables the table (argmin + LRU only).
    * ``precompile_m_max`` — when > 0, compiling an op through this engine
      eagerly warms every executable bucket reachable for extents up to
      this value (only for workloads whose executables are not specialized
      on outer dims — those need representative args, see
      ``CompiledOp.precompile``).
    * ``staging`` — serve unaligned extents through the masked-tail staging
      hot path (engine-owned bucket buffers + one launch).  False sends
      every call to the zero-pad reference path — a parity/debugging knob,
      not a serving configuration.
    * ``staging_pool_cap`` — LRU bound on the staging-buffer sets each
      executable entry retains (``_StagingPool``); 0 retains nothing
      (every unaligned call allocates transient buffers).
    * ``calibration`` — background calibration of the selection tables
      (core/calibrate.py): ``"off"`` (default; nothing is constructed and
      dispatch is exactly the analytical engine's), ``"on-idle"`` (the
      continuous scheduler donates budgeted slices when idle, or a
      ``launch.calibration.CalibrationDaemon`` does) or
      ``"eager-warmup"`` (load from disk, else measure, as each kernel is
      built).
    * ``calibration_top_k`` — analytically best candidates timed per
      measured bucket (plus the analytical winner).
    * ``calibration_budget_s`` — wall-clock bound of ONE donated slice.
    * ``calibration_cache_dir`` — where calibrated tables persist (None:
      ``$VORTEX_CACHE_DIR``, else ``~/.cache/vortex``; never inside the
      repo).
    """

    hardware: str = "h100_sxm"
    backends: tuple[str, ...] | None = None
    device: str = "cuda"
    impl: str | None = None
    empirical_levels: tuple[int, ...] | None = None
    table_m_max: int = 4096
    table_extend_limit: int = 1 << 17
    precompile_m_max: int = 0
    staging: bool = True
    staging_pool_cap: int = 4
    calibration: str = "off"
    calibration_top_k: int = 3
    calibration_budget_s: float = 0.25
    calibration_cache_dir: str | None = None

    def __post_init__(self) -> None:
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", str(dev))
        object.__setattr__(self, "impl", resolve_impl(dev, self.impl))
        if self.backends is not None:
            object.__setattr__(self, "backends", tuple(self.backends))
        if self.empirical_levels is not None:
            object.__setattr__(
                self, "empirical_levels", tuple(self.empirical_levels)
            )
        for name in ("table_m_max", "table_extend_limit",
                     "precompile_m_max", "staging_pool_cap"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )
        if self.calibration not in ("off", "on-idle", "eager-warmup"):
            raise ValueError(
                f"calibration must be 'off', 'on-idle' or 'eager-warmup', "
                f"got {self.calibration!r}"
            )
