"""Resilience layer of the PyTorch port (counterpart of ``sketches_tpu.resilience``).

Every failure path is a degradation path, recorded:

* **Error taxonomy** (:class:`SketchError` and friends): class names,
  bases and fields are the JAX package's, so callers catch and read the
  same types from either package.
* **Health ledger** (:func:`record_downgrade` / :func:`bump` /
  :func:`health`): the process-wide record of every degradation a
  component took (a query tier demoted, the ingest kernel lost, the native
  host tier lost, blobs quarantined, shards dead).  A downgrade is never
  silent: a caller that survives a failure records it here.
* **Reports** (:class:`QuarantineReport`, :class:`ShardLossReport`,
  :class:`ReshardReport`): the accounting the quarantine decode
  (``pb.wire.bytes_to_state(errors="quarantine")``), the lost-shard fold
  (``parallel.DistributedDDSketch.merge_partial``) and ``reshard`` hand
  back.

Ladder semantics are the JAX package's: the query tiers degrade
``overlap -> tiles -> windowed -> wxla -> xla`` (:data:`QUERY_LADDER`,
:func:`demote_query_tier`); ingest degrades from the fused kernel to the
plain path (the port's engine names, ``kernel -> plain``, where the JAX
package writes ``pallas -> xla``); the host tier degrades
``native -> python``.  Every tier computes the same answer.

The ledger takes its timestamps from :func:`wall_time`, which reads
``telemetry.wall_time`` (the port's one clock boundary).  Armed telemetry
mirrors each downgrade as a ``resilience.downgrade`` counter and trace
instant, and the armed flight recorder as a ``resilience.downgrade``
event, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from sketches_tpu_torch import telemetry

__all__ = [
    "SketchError",
    "SketchValueError",
    "SpecError",
    "UnequalSketchParametersError",
    "WireDecodeError",
    "BlobTooLarge",
    "CheckpointCorrupt",
    "IntegrityError",
    "EngineUnavailable",
    "ShardLossError",
    "InjectedFault",
    "ServeOverload",
    "DeadlineExceeded",
    "ReplicaStale",
    "FabricUnavailable",
    "QuarantineRecord",
    "QuarantineReport",
    "ShardLossReport",
    "ReshardReport",
    "DowngradeEvent",
    "record_downgrade",
    "bump",
    "health",
    "reset",
    "QUERY_LADDER",
    "demote_query_tier",
    "survivable",
    "demote_query",
]


class SketchError(Exception):
    """Base of every structured error this package raises on its own behalf."""


class SketchValueError(SketchError, ValueError):
    """A caller handed the library an unusable value (bad weight, ragged
    batch width, refused wire bytes).  Subclasses ``ValueError`` so
    pre-taxonomy ``except ValueError`` call sites keep working."""


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


class IntegrityError(SketchError):
    """Sketch state failed a self-verification: total-mass conservation,
    bin non-negativity, derived-counter agreement, or a cross-boundary
    fingerprint mismatch (``sketches_tpu_torch.integrity``).  Deliberately
    not a ``ValueError``.  Carries the
    :class:`~sketches_tpu_torch.integrity.IntegrityReport` as ``.report``
    when raised by the integrity layer's armed policy."""

    def __init__(self, message: str, report=None):
        super().__init__(message)
        self.report = report


class EngineUnavailable(SketchError, RuntimeError):
    """An execution engine cannot be used: a kernel failed to build, load or
    launch.  Subclasses ``RuntimeError``."""


class ShardLossError(SketchError):
    """Raised on unrecoverable shard loss: no live shard remains to fold."""


class InjectedFault(SketchError):
    """The deterministic failure raised by an armed ``faults`` site."""


class ServeOverload(SketchError):
    """A serving request was shed at admission (global queue at depth,
    tenant over quota, or an armed ``serve.queue_overflow`` fault).
    ``reason`` is the stable shed class (``queue_depth`` /
    ``tenant_quota`` / ``injected``).  Raised by the serving tier, which
    the port has not reached yet."""

    def __init__(self, message: str, reason: str = "", tenant: str = ""):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


class DeadlineExceeded(SketchError):
    """A serving request's deadline budget was spent before any dispatch
    could answer it (serving tier).  Raised at admission/flush time -- a
    request near (but not past) its deadline degrades to the cheapest
    engine tier instead of raising."""


class ReplicaStale(SketchError):
    """A serve-fabric read replica refused to answer: its content
    fingerprint no longer matches the primary's ledgered state, or its
    sync lag exceeds the tenant's staleness bound.  ``reason`` is the
    stable refusal class (``fingerprint`` / ``staleness``)."""

    def __init__(self, message: str, reason: str = "", tenant: str = ""):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant


class FabricUnavailable(SketchError):
    """No serveable copy of a fabric tenant remains: the primary host is
    dead or partitioned and every replica either refused
    (:class:`ReplicaStale`) or lives on a dead/partitioned host.  Raised
    instead of serving a wrong or out-of-contract answer -- unavailability
    is declared, never improvised around."""


# ---------------------------------------------------------------------------
# Health ledger
# ---------------------------------------------------------------------------


def wall_time() -> float:
    """The ledger's clock: wall seconds through ``telemetry.wall_time``.
    Timestamps are operator-facing; nothing branches on them."""
    return telemetry.wall_time()


@dataclasses.dataclass(frozen=True)
class DowngradeEvent:
    """One recorded degradation: ``component`` moved ``from_tier`` ->
    ``to_tier`` because ``reason``."""

    component: str
    from_tier: str
    to_tier: str
    reason: str
    time: float


_lock = threading.Lock()
_events: List[DowngradeEvent] = []
_tiers: Dict[str, str] = {}
_counters: Dict[str, float] = {}
_events_dropped = 0

#: Ledger ring bound: events past the cap are dropped (newest first) and
#: counted in ``health()["downgrades_dropped"]``; the per-component
#: ``tiers`` map and the counters keep aggregating regardless.
_MAX_EVENTS = 65536


def record_downgrade(
    component: str, from_tier: str, to_tier: str, reason: str = ""
) -> DowngradeEvent:
    """Record one degradation step into the process-wide health ledger.

    Never fails the caller: a downgrade is already a failure being
    survived.  ``reason`` is cut to 500 characters.  Armed telemetry
    mirrors the event as a ``resilience.downgrade`` counter + trace
    instant, so ledger and metrics snapshot agree; the armed flight
    recorder keeps it as a ``resilience.downgrade`` event.
    """
    ev = DowngradeEvent(component, from_tier, to_tier, str(reason)[:500], wall_time())
    global _events_dropped
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
        else:
            _events_dropped += 1
        _tiers[component] = to_tier
        _counters["downgrades"] = _counters.get("downgrades", 0) + 1
    if telemetry._ACTIVE:
        telemetry.event(
            "resilience.downgrade",
            component=component, from_tier=from_tier, to_tier=to_tier,
        )
    # Lazy import: tracing reaches this module's taxonomy at call time.
    from sketches_tpu_torch import tracing

    if tracing._ACTIVE:
        tracing.record_event(
            "resilience.downgrade", component=component,
            from_tier=from_tier, to_tier=to_tier, reason=str(reason)[:200],
        )
    return ev


def bump(name: str, n: float = 1) -> None:
    """Increment a named health counter (quarantined blobs, fired faults,
    dead shards, ...)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def health() -> dict:
    """Snapshot of the ledger: ``{"tiers": {component: current tier},
    "counters": {...}, "downgrades": [event dicts, oldest first],
    "downgrades_dropped": n}``.  Empty maps are the healthy steady state.
    The snapshot is a deep copy; mutating it does not touch the ledger."""
    with _lock:
        return {
            "tiers": dict(_tiers),
            "counters": dict(_counters),
            "downgrades": [dataclasses.asdict(e) for e in _events],
            "downgrades_dropped": _events_dropped,
        }


def reset() -> None:
    """Clear the ledger (test isolation hook)."""
    global _events_dropped
    with _lock:
        _events.clear()
        _tiers.clear()
        _counters.clear()
        _events_dropped = 0


# ---------------------------------------------------------------------------
# Engine ladder bookkeeping
# ---------------------------------------------------------------------------

#: The query-engine degradation order, fastest first.  ``xla`` (the full
#: quantile) is the floor and may not fail over further.
QUERY_LADDER = ("overlap", "tiles", "windowed", "wxla", "xla")


def demote_query_tier(disabled: set, tier: str) -> Optional[str]:
    """Disable ``tier`` in a facade's ladder state -> the next tier label.

    Returns ``None`` when ``tier`` is the floor (the caller must re-raise).
    A ``windowed`` failure disables the whole kernel query family
    (``overlap``, ``tiles`` and ``windowed``), as in the JAX package.
    """
    if tier == "overlap":
        disabled.add("overlap")
        return "tiles"
    if tier == "tiles":
        disabled.add("tiles")
        return "windowed"
    if tier == "windowed":
        disabled.update(("overlap", "tiles", "windowed"))
        return "wxla"
    if tier == "wxla":
        disabled.add("wxla")
        return "xla"
    return None


def survivable(exc: BaseException, on_card: bool) -> bool:
    """Whether a facade may step down its ladder after ``exc``.

    On the card only an armed fault site's :class:`InjectedFault` is
    survived: a real kernel build or launch error raises, so no kernel is
    ever replaced by its plain version on CUDA tensors.  Off the card every
    tier is plain PyTorch already, and any failure steps down as in the JAX
    package.
    """
    return not on_card or isinstance(exc, InjectedFault)


def demote_query(
    component: str, disabled: set, tier: str, exc: BaseException, on_card: bool
) -> bool:
    """One query-ladder step for a facade: disable ``tier`` in ``disabled``
    and record ``component.query tier -> next`` -> True when the caller may
    retry on the next tier; False (re-raise) at the floor, or on the card
    for anything but an injected fault (:func:`survivable`)."""
    if not survivable(exc, on_card):
        return False
    nxt = demote_query_tier(disabled, tier)
    if nxt is None:
        return False
    record_downgrade(f"{component}.query", tier, nxt, repr(exc))
    return True


@dataclasses.dataclass
class ShardLossReport:
    """Accounting for a liveness-masked partial fold.

    The folded state is an exact sketch of the surviving shards' mass (each
    partial is itself a sketch); ``dropped_count`` is the per-stream mass
    left behind with the dead shards, derivable only while the dead
    partials are still readable (simulation, post-mortem), and None where
    it cannot be known.
    """

    live: np.ndarray  # [K] bool
    surviving_count: np.ndarray  # [N]
    dropped_count: Optional[np.ndarray]  # [N], None if unknowable

    @property
    def dead_shards(self) -> List[int]:
        return [int(i) for i in np.nonzero(~self.live)[0]]

    @property
    def n_dead(self) -> int:
        return int((~self.live).sum())

    @property
    def dropped_fraction(self) -> Optional[np.ndarray]:
        """Per-stream fraction of total mass lost with the dead shards."""
        if self.dropped_count is None:
            return None
        total = self.surviving_count + self.dropped_count
        return self.dropped_count / np.maximum(total, 1.0)

    @property
    def total_dropped_fraction(self) -> Optional[float]:
        if self.dropped_count is None:
            return None
        total = float(self.surviving_count.sum() + self.dropped_count.sum())
        return float(self.dropped_count.sum()) / max(total, 1.0)


@dataclasses.dataclass
class ReshardReport:
    """Accounting for one reshard (fold the survivors, regrow elsewhere).

    The regrown fleet holds exactly the surviving mass: ``surviving_count``
    must reappear bit-identically in the new fleet's fold (``exact``), and
    the mass lost with dead shards and lost hosts is itemized per stream in
    ``dropped_count``.  ``fingerprint_pre`` / ``fingerprint_post`` carry
    the integrity layer's merge-additive content fingerprints across the
    boundary when it is armed (``None`` disarmed: an absent proof, not a
    passed one); ``fingerprints_match`` is then the verdict.  A reshard
    that raises (torn, all dead) produces no report and leaves the
    original fleet untouched.
    """

    live: np.ndarray  # [K] bool, over the old mesh's value shards
    from_devices: int
    to_devices: int
    surviving_count: np.ndarray  # [N]
    dropped_count: np.ndarray  # [N]
    exact: bool
    lost_hosts: Tuple[int, ...] = ()
    fingerprint_pre: Optional[np.ndarray] = None  # [N], armed only
    fingerprint_post: Optional[np.ndarray] = None  # [N], armed only

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

    @property
    def fingerprints_match(self) -> Optional[bool]:
        """Cross-boundary fingerprint verdict (None when integrity was
        disarmed and no fingerprints were computed)."""
        if self.fingerprint_pre is None or self.fingerprint_post is None:
            return None
        return bool(
            np.allclose(self.fingerprint_post, self.fingerprint_pre, rtol=1e-5, atol=1e-3)
        )


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
