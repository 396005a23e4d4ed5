"""Contextvar-scoped engine sessions: ``vortex.use`` / ``current_engine``.

The engine an op or model layer serves from is an ambient *session*, not a
mutable module global: installation is a :class:`contextvars.ContextVar`,
so scopes nest, restore on exception, and are isolated per thread (and per
asyncio task) — two serving threads with different engines cannot observe
each other.

``current_engine()`` falls back to one lazily-created process-default
engine (the default :class:`EngineConfig`: the H100 lattice on the card,
which raises where no GPU is present), so ``vortex.ops.gemm(a, b)`` works
out of the box on the card; ``installed_engine()`` returns None instead — it is what
opt-in integrations (model layers) consult, so merely importing vortex
never reroutes a model through a default engine nobody asked for.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import TYPE_CHECKING, Iterator

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.vortex.engine import Engine

__all__ = ["use", "install", "current_engine", "installed_engine",
           "default_engine"]

_ENGINE: contextvars.ContextVar["Engine | None"] = contextvars.ContextVar(
    "repro_torch_vortex_engine", default=None
)

_default_engine: "Engine | None" = None
_default_lock = threading.Lock()


@contextlib.contextmanager
def use(engine: "Engine") -> Iterator["Engine"]:
    """Install ``engine`` as the session for the enclosed context::

        with vortex.use(Engine(cfg)) as eng:
            vortex.ops.gemm(a, b)          # served by eng

    Nestable (innermost wins), exception-safe (the previous session is
    restored by token on ANY exit), and thread/task-local by construction.
    """
    token = _ENGINE.set(engine)
    try:
        yield engine
    finally:
        _ENGINE.reset(token)


def install(engine: "Engine | None") -> "Engine | None":
    """Imperatively replace the current context's session, returning the
    previous one.  Prefer :func:`use`; this exists for the deprecated
    ``set_attention_engine`` shim: unlike :func:`use` it cannot restore
    across an exception for you."""
    prev = _ENGINE.get()
    _ENGINE.set(engine)
    return prev


def installed_engine() -> "Engine | None":
    """The innermost explicitly-installed engine, or None.  Opt-in
    integrations (models/layers.attn_forward) use this: no installation,
    no rerouting."""
    return _ENGINE.get()


def default_engine() -> "Engine":
    """The lazily-created process-default engine (default config)."""
    global _default_engine
    if _default_engine is None:
        with _default_lock:
            if _default_engine is None:
                from repro_torch.vortex.engine import Engine

                _default_engine = Engine()
    return _default_engine


def current_engine() -> "Engine":
    """The engine serving this context: the innermost :func:`use`
    installation, else the process-default."""
    eng = _ENGINE.get()
    return eng if eng is not None else default_engine()
