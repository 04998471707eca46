"""Error taxonomy of the PyTorch port (counterpart of ``sketches_tpu.resilience``).

Only the exception classes live here for now; the engine-health ledger and
its demotion reports follow with the robustness slice.  The class names and
bases match the JAX package's, so callers catch the same types from either.
"""

from __future__ import annotations

__all__ = [
    "SketchError",
    "SketchValueError",
    "SpecError",
    "UnequalSketchParametersError",
    "EngineUnavailable",
]


class SketchError(Exception):
    """Base of every structured error this package raises on its own behalf."""


class SketchValueError(SketchError, ValueError):
    """A caller handed the library an unusable value (bad weight, ragged
    batch width).  Subclasses ``ValueError``."""


class SpecError(SketchValueError):
    """Invalid static configuration: sketch/spec constructor arguments,
    engine names, devices."""


class UnequalSketchParametersError(SketchValueError):
    """Raised when merging sketches whose specs (gamma, window) differ."""


class EngineUnavailable(SketchError, RuntimeError):
    """An execution engine cannot be used: a kernel failed to build, load or
    launch.  Subclasses ``RuntimeError``."""
