"""The port's deprecation machinery (counterpart of
src/repro/vortex/_deprecation.py).

Every shim warns with :class:`VortexDeprecationWarning` (a
``DeprecationWarning`` subclass) rather than the stdlib category, so a
test run can turn the port's own deprecations into errors without also
erroring on upstream ones from torch or numpy.
"""
from __future__ import annotations

import warnings

__all__ = ["VortexDeprecationWarning", "warn_deprecated"]


class VortexDeprecationWarning(DeprecationWarning):
    """A deprecated surface was used; migrate to ``repro_torch.vortex``."""


def warn_deprecated(old: str, new: str, *, stacklevel: int = 3) -> None:
    warnings.warn(
        f"{old} is deprecated and will be removed; use {new} instead "
        "(see DESIGN.md § Public API for the migration)",
        VortexDeprecationWarning,
        stacklevel=stacklevel,
    )
