"""Pluggable columnar execution backends (DESIGN.md §9).

The table layer (:class:`repro_torch.data.tables.Table`) dispatches its
physical operators — ``hash_join``, ``group_by_agg``, ``filter_select``,
``concat`` — through this registry, so *what* a pipeline computes
(contracts, NULL semantics, row order) is fixed while *how* it executes
is swappable:

- ``reference``  — the original interpreted row loops, kept as the
  differential-testing oracle;
- ``vectorized`` — numpy factorize/sort kernels;
- ``torch``      — group-by aggregation in the CUDA segment kernels
  (``kernels/segment_sum``), on the card. The default.

Selection, in precedence order:

1. per-call override: ``table.join(other, on=[...], backend="reference")``;
2. process-wide: :func:`set_backend` / the :func:`use_backend` context
   manager (process-global, *not* thread-scoped — the engine's wave
   threads all see it, which is exactly what keeps one run on one
   backend). Both take a registered name or a :class:`Backend`
   instance, e.g. ``use_backend(TorchBackend(device="cpu"))``;
3. environment: ``REPRO_TORCH_EXEC_BACKEND`` at first use;
4. default: ``torch`` on ``cuda``.

The default runs on the card: without CUDA, selecting it raises
:class:`BackendUnavailable`, naming how to ask for the CPU instead.
Backends are registered as *factories* and instantiated lazily, so
importing this package never imports torch. The engine folds
:func:`active_backend`'s cache token into every node cache key
(``repro_torch.core.engine.cache_key``), so switching backends or
devices can never serve a snapshot computed by a different
implementation.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable

from repro_torch.exec.base import Backend, Columns, fill_value, payload_validity

__all__ = [
    "Backend", "Columns", "fill_value", "payload_validity",
    "BackendUnavailable", "register", "get_backend", "available_backends",
    "active_backend", "set_backend", "use_backend", "resolve",
    "DEFAULT_BACKEND",
]

DEFAULT_BACKEND = "torch"


class BackendUnavailable(RuntimeError):
    """A registered backend cannot be constructed (missing dependency
    or device)."""


_lock = threading.Lock()
_factories: dict[str, Callable[[], Backend]] = {}
_instances: dict[str, Backend] = {}
_active: "str | Backend | None" = None  # resolved lazily (env) on first use


def register(name: str, factory: Callable[[], Backend]) -> None:
    """Register a backend factory. Construction is deferred to first
    :func:`get_backend` so optional dependencies stay optional."""
    _factories[name] = factory


def get_backend(name: str) -> Backend:
    with _lock:
        be = _instances.get(name)
        if be is not None:
            return be
        factory = _factories.get(name)
        if factory is None:
            raise KeyError(
                f"unknown execution backend {name!r}; registered: "
                f"{sorted(_factories)}")
        try:
            be = factory()
        except ImportError as e:
            raise BackendUnavailable(
                f"execution backend {name!r} is unavailable: {e}") from e
        _instances[name] = be
        return be


def available_backends() -> list[str]:
    """Names of backends that actually construct on this install."""
    out = []
    for name in sorted(_factories):
        try:
            get_backend(name)
        except BackendUnavailable:
            continue
        out.append(name)
    return out


def _default_name() -> str:
    return os.environ.get("REPRO_TORCH_EXEC_BACKEND", DEFAULT_BACKEND)


def active_backend() -> Backend:
    global _active
    if _active is None:
        _active = _default_name()
    return resolve(_active)


def set_backend(backend: "str | Backend") -> None:
    """Select the process-wide backend (validates availability now)."""
    global _active
    resolve(backend)
    _active = backend


@contextmanager
def use_backend(backend: "str | Backend"):
    """Temporarily select a backend (process-global, not thread-scoped)."""
    global _active
    prev = _active
    set_backend(backend)
    try:
        yield resolve(backend)
    finally:
        _active = prev


def resolve(backend: "str | Backend | None") -> Backend:
    """Per-call dispatch: None -> active, str -> registry, Backend -> it."""
    if backend is None:
        return active_backend()
    if isinstance(backend, Backend):
        return backend
    return get_backend(backend)


def _reference_factory() -> Backend:
    from repro_torch.exec.reference import ReferenceBackend
    return ReferenceBackend()


def _vectorized_factory() -> Backend:
    from repro_torch.exec.vectorized import VectorizedBackend
    return VectorizedBackend()


def _torch_factory() -> Backend:
    from repro_torch.exec.torch_backend import TorchBackend  # imports torch
    return TorchBackend()


register("reference", _reference_factory)
register("vectorized", _vectorized_factory)
register("torch", _torch_factory)
