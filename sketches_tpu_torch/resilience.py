"""Error taxonomy of the PyTorch port (counterpart of ``sketches_tpu.resilience``).

The exception classes, the two reports of the distributed tier's
shard-loss and reshard accounting, and the quarantine report of the bulk
wire decode (``pb.wire.bytes_to_state(errors="quarantine")``).  The
engine-health ledger and its demotion records follow with the robustness
slice.  Class names, bases and
fields match the JAX package's, so callers catch and read the same types
from either.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = [
    "SketchError",
    "SketchValueError",
    "SpecError",
    "UnequalSketchParametersError",
    "WireDecodeError",
    "BlobTooLarge",
    "CheckpointCorrupt",
    "EngineUnavailable",
    "ShardLossError",
    "QuarantineRecord",
    "QuarantineReport",
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


class WireDecodeError(SketchValueError):
    """A wire blob failed the decode contract (structure, limits)."""


class BlobTooLarge(WireDecodeError):
    """Raised (or quarantined as ``over_limit``) when a wire blob exceeds
    the caller's ``max_blob_bytes`` admission cap."""


class CheckpointCorrupt(SketchError):
    """A checkpoint failed restore validation: truncated file, bad
    archive, checksum mismatch, or missing fields.  Deliberately not a
    ``ValueError``: corruption is an integrity failure, not a bad
    argument, and must not be swallowed by value-error handlers."""


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


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One quarantined blob: its batch index, a stable reason ``kind``
    (``unparseable`` / ``mapping_mismatch`` / ``over_limit`` /
    ``invalid`` / ``error``), the exception class name, and its message."""

    index: int
    kind: str
    error: str
    message: str


@dataclasses.dataclass
class QuarantineReport:
    """Accounting for one quarantine-mode bulk decode.

    ``records`` lists every quarantined blob (index + structured reason),
    in batch order.  Quarantined streams decode as empty rows (zero mass)
    in the returned state; every other stream decodes bit-identically to a
    clean decode of the same blob.
    """

    total: int
    records: List[QuarantineRecord] = dataclasses.field(default_factory=list)

    def add(self, index: int, kind: str, exc: BaseException) -> None:
        self.records.append(
            QuarantineRecord(index, kind, type(exc).__name__, str(exc)[:500])
        )

    @property
    def indices(self) -> List[int]:
        return [r.index for r in self.records]

    @property
    def counters(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + 1
        return out

    @property
    def n_quarantined(self) -> int:
        return len(self.records)

    @property
    def n_ok(self) -> int:
        return self.total - len(self.records)

    def __bool__(self) -> bool:  # truthy iff anything was quarantined
        return bool(self.records)
