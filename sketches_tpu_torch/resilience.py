"""Error taxonomy of the PyTorch port (counterpart of ``sketches_tpu.resilience``).

The exception classes, and the two reports of the distributed tier's
shard-loss and reshard accounting.  The engine-health ledger and its
demotion records follow with the robustness slice.  Class names, bases and
fields match the JAX package's, so callers catch and read the same types
from either.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = [
    "SketchError",
    "SketchValueError",
    "SpecError",
    "UnequalSketchParametersError",
    "EngineUnavailable",
    "ShardLossError",
    "ShardLossReport",
    "ReshardReport",
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


class ShardLossError(SketchError):
    """Raised on unrecoverable shard loss: no live shard remains to fold."""


@dataclasses.dataclass
class ShardLossReport:
    """Accounting for a liveness-masked partial fold.

    The folded state is an exact sketch of the surviving shards' mass (each
    partial is itself a sketch); ``dropped_count`` is the per-stream mass
    left behind with the dead shards.
    """

    live: np.ndarray  # [K] bool
    surviving_count: np.ndarray  # [N]
    dropped_count: np.ndarray  # [N]

    @property
    def dead_shards(self) -> List[int]:
        return [int(i) for i in np.nonzero(~self.live)[0]]

    @property
    def n_dead(self) -> int:
        return int((~self.live).sum())

    @property
    def dropped_fraction(self) -> np.ndarray:
        """Per-stream fraction of total mass lost with the dead shards."""
        total = self.surviving_count + self.dropped_count
        return self.dropped_count / np.maximum(total, 1.0)

    @property
    def total_dropped_fraction(self) -> float:
        total = float(self.surviving_count.sum() + self.dropped_count.sum())
        return float(self.dropped_count.sum()) / max(total, 1.0)


@dataclasses.dataclass
class ReshardReport:
    """Accounting for one reshard (fold the survivors, regrow elsewhere).

    The regrown fleet holds exactly the surviving mass: ``surviving_count``
    must reappear bit-identically in the new fleet's fold (``exact``), and
    the mass lost with dead shards is itemized per stream in
    ``dropped_count``.
    """

    live: np.ndarray  # [K] bool, over the old mesh's value shards
    from_devices: int
    to_devices: int
    surviving_count: np.ndarray  # [N]
    dropped_count: np.ndarray  # [N]
    exact: bool

    @property
    def dead_shards(self) -> List[int]:
        return [int(i) for i in np.nonzero(~self.live)[0]]

    @property
    def n_dead(self) -> int:
        return int((~self.live).sum())

    @property
    def total_dropped(self) -> float:
        return float(self.dropped_count.sum())

    @property
    def total_dropped_fraction(self) -> float:
        total = float(self.surviving_count.sum() + self.dropped_count.sum())
        return self.total_dropped / max(total, 1.0)
