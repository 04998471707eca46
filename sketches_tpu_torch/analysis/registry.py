"""The kill-switch inventory of the PyTorch port: every ``SKETCHES_TPU_*``
environment variable (counterpart of ``sketches_tpu/analysis/registry.py``).

The port reads the JAX package's switches under the same names, defaults
and docs, so one environment drives both packages.  This registry is the
one place such a variable is declared and read: each :class:`EnvVar`
carries the name, the default, the owning module of the port, and a
one-line doc; modules read them through :func:`get` / :func:`enabled`.
Variables whose module has not been ported yet (telemetry, serving,
windows, fabric) are declared all the same, so a lookup by name never
differs between the packages.

This module is stdlib-only and imports nothing from the rest of the
package (``faults``, ``integrity``, ``native``, ``kernels`` and
``backends.uniform`` read it at import or call time), so any module may
import it without cycles.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

__all__ = [
    "EnvVar",
    "NATIVE",
    "OVERLAP",
    "FAULTS",
    "TELEMETRY",
    "INTEGRITY",
    "PROFILING",
    "ACCURACY_AUDIT",
    "SERVE_CACHE",
    "SERVE_HEDGE",
    "ELASTIC",
    "FLIGHT_RECORDER",
    "INGEST_PACKED",
    "ADAPTIVE",
    "WINDOWED",
    "WINDOW_AGG",
    "FABRIC",
    "REGISTRY",
    "declared",
    "get",
    "enabled",
    "lookup",
]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One declared environment variable.

    ``default`` is the exact string :func:`get` returns when the process
    environment does not set the variable (``None`` means "unset", for
    variables like the fault spec whose mere presence arms behavior).
    ``owner`` is the module whose behavior the variable controls;
    ``doc`` is the one-line description (the JAX package's, verbatim).
    """

    name: str
    default: Optional[str]
    owner: str
    doc: str


#: The native-engine kill switch (``sketches_tpu_torch.native``).
NATIVE = EnvVar(
    name="SKETCHES_TPU_NATIVE",
    default="1",
    owner="sketches_tpu_torch.native",
    doc=(
        "Set to 0 to force the native C++ host engine unavailable"
        " (pure-Python host tier); the degraded-mode CI lever."
    ),
)

#: The overlap-query-engine kill switch (``sketches_tpu_torch.kernels``).
OVERLAP = EnvVar(
    name="SKETCHES_TPU_OVERLAP",
    default="1",
    owner="sketches_tpu_torch.kernels",
    doc=(
        "Set to 0 to disconnect the overlap query engine; facades"
        " answer through the windowed/tiles ladder instead."
    ),
)

#: Process-start fault arming (``sketches_tpu_torch.faults``).
FAULTS = EnvVar(
    name="SKETCHES_TPU_FAULTS",
    default=None,
    owner="sketches_tpu_torch.faults",
    doc=(
        "Semicolon-separated fault-site plans armed at process"
        " start (e.g. native.load;wire.blob:fraction=0.01,seed=7);"
        " unset/empty means no injection."
    ),
)

#: Telemetry arming (``sketches_tpu_torch.telemetry``).
TELEMETRY = EnvVar(
    name="SKETCHES_TPU_TELEMETRY",
    default="0",
    owner="sketches_tpu_torch.telemetry",
    doc=(
        "Set to 1 to arm the self-sketching telemetry layer (metric"
        " registry + trace spans); 0/unset leaves it off -- one bool"
        " test per instrumented dispatch."
    ),
)

#: Integrity-layer arming (``sketches_tpu_torch.integrity``).
INTEGRITY = EnvVar(
    name="SKETCHES_TPU_INTEGRITY",
    default="0",
    owner="sketches_tpu_torch.integrity",
    doc=(
        "Set to 1 to arm the self-verifying integrity layer (invariant"
        " checks + fingerprints at the guarded seams; violations raise"
        " IntegrityError) or to quarantine to report instead of raising;"
        " 0/unset leaves it off -- one bool test per guarded seam."
    ),
)

#: Device-time profiling arming (``sketches_tpu_torch.profiling``).
PROFILING = EnvVar(
    name="SKETCHES_TPU_PROFILING",
    default="0",
    owner="sketches_tpu_torch.profiling",
    doc=(
        "Set to 1 to arm device-time attribution: every engine dispatch"
        " blocks until the device finishes and the time is attributed per"
        " engine tier and phase; 0/unset leaves it off -- one bool test"
        " per dispatch."
    ),
)

#: Accuracy-drift shadow audit arming (``sketches_tpu_torch.accuracy``).
ACCURACY_AUDIT = EnvVar(
    name="SKETCHES_TPU_ACCURACY_AUDIT",
    default="0",
    owner="sketches_tpu_torch.accuracy",
    doc=(
        "Set to 1 to arm the accuracy-drift shadow audit: watched sketches"
        " keep a bounded reservoir sample and periodically verify realized"
        " quantile error against the alpha contract; 0/unset leaves it off"
        " -- one bool test per ingest."
    ),
)

#: Serving-tier result-cache kill switch (``sketches_tpu_torch.serve``).
SERVE_CACHE = EnvVar(
    name="SKETCHES_TPU_SERVE_CACHE",
    default="1",
    owner="sketches_tpu_torch.serve",
    doc=(
        "Set to 0 to disable the serving tier's fingerprint-keyed"
        " result cache (every query recomputes; no fingerprint fetch,"
        " no poison checks)."
    ),
)

#: Flight-recorder / request-tracing kill switch (``sketches_tpu_torch.tracing``).
FLIGHT_RECORDER = EnvVar(
    name="SKETCHES_TPU_FLIGHT_RECORDER",
    default="1",
    owner="sketches_tpu_torch.tracing",
    doc=(
        "Set to 0 to keep the flight recorder and request tracing"
        " disarmed even while telemetry is armed (no trace contexts, no"
        " event ring, no forensic dumps); any other value arms them"
        " together with the telemetry layer."
    ),
)

#: Elastic-resharding kill switch (``sketches_tpu_torch.parallel``).
ELASTIC = EnvVar(
    name="SKETCHES_TPU_ELASTIC",
    default="1",
    owner="sketches_tpu_torch.parallel",
    doc=(
        "Set to 0 to refuse live elastic resharding"
        " (DistributedDDSketch.reshard raises SpecError; the fleet"
        " keeps its fixed topology -- checkpoint/restore still works)."
    ),
)

#: Serving-tier hedged-retry kill switch (``sketches_tpu_torch.serve``).
SERVE_HEDGE = EnvVar(
    name="SKETCHES_TPU_SERVE_HEDGE",
    default="1",
    owner="sketches_tpu_torch.serve",
    doc=(
        "Set to 0 to disable hedged retries for straggling serve"
        " dispatches; a straggler's failure then surfaces to the"
        " request as a structured error instead of being hedged around."
    ),
)

#: Packed-ingest-variant kill switch (``sketches_tpu_torch.kernels``).
INGEST_PACKED = EnvVar(
    name="SKETCHES_TPU_INGEST_PACKED",
    default="1",
    owner="sketches_tpu_torch.kernels",
    doc=(
        "Set to 0 to pin the fused ingest kernel to the stock int8"
        " one-hot construction; facades then never select the packed"
        " sub-byte / folded construction variants (the measured-dead"
        " escape hatch for the r17 construction-width rungs)."
    ),
)

#: Adaptive-accuracy backend kill switch (``sketches_tpu_torch.backends``).
ADAPTIVE = EnvVar(
    name="SKETCHES_TPU_ADAPTIVE",
    default="1",
    owner="sketches_tpu_torch.backends",
    doc=(
        "Set to 0 to refuse adaptive-accuracy collapses: a"
        " uniform-collapse trigger (or explicit collapse call) raises"
        " SpecError instead of degrading alpha; dense and moment"
        " backends are unaffected."
    ),
)

#: Time-windowed-quantile kill switch (``sketches_tpu_torch.windows``).
WINDOWED = EnvVar(
    name="SKETCHES_TPU_WINDOWED",
    default="1",
    owner="sketches_tpu_torch.windows",
    doc=(
        "Set to 0 to refuse time-windowed sketches: constructing a"
        " WindowedSketch (or serving a window= query) raises SpecError"
        " instead of silently answering unwindowed; plain facades are"
        " unaffected."
    ),
)

#: Incremental window-aggregation kill switch (``sketches_tpu_torch.windows``).
WINDOW_AGG = EnvVar(
    name="SKETCHES_TPU_WINDOW_AGG",
    default="1",
    owner="sketches_tpu_torch.windows",
    doc=(
        "Set to 0 to disable the maintained two-stacks window"
        " aggregates: every window query falls back to the full"
        " re-merge over the covered buckets (the pre-aggregation"
        " path); answers stay correct, only the per-query merge count"
        " grows back to O(covered buckets)."
    ),
)

#: Sharded-serve-fabric kill switch (``sketches_tpu_torch.fabric``).
FABRIC = EnvVar(
    name="SKETCHES_TPU_FABRIC",
    default="1",
    owner="sketches_tpu_torch.fabric",
    doc=(
        "Set to 0 to refuse the sharded serve fabric: constructing a"
        " ServeFabric raises SpecError instead of silently serving"
        " unreplicated; single-process SketchServer tenants are"
        " unaffected."
    ),
)

#: Every SKETCHES_TPU_* variable the package reads, by name.
REGISTRY: Dict[str, EnvVar] = {
    v.name: v
    for v in (
        NATIVE, OVERLAP, FAULTS, TELEMETRY, INTEGRITY, PROFILING,
        ACCURACY_AUDIT, SERVE_CACHE, SERVE_HEDGE, ELASTIC,
        FLIGHT_RECORDER, INGEST_PACKED, ADAPTIVE, WINDOWED, WINDOW_AGG,
        FABRIC,
    )
}


def declared() -> Tuple[EnvVar, ...]:
    """Every registered variable, in declaration order."""
    return tuple(REGISTRY.values())


def lookup(name: str) -> EnvVar:
    """The :class:`EnvVar` declared under ``name`` (KeyError if absent)."""
    return REGISTRY[name]


def _resolve(var) -> EnvVar:
    if isinstance(var, EnvVar):
        return REGISTRY[var.name]  # refuse undeclared ad-hoc instances too
    return REGISTRY[var]


def get(var) -> Optional[str]:
    """Read a registered variable (:class:`EnvVar` or name) from the
    process environment.

    Returns the declared default when the environment does not set the
    variable.  Raises ``KeyError`` for an undeclared variable -- reading
    an unregistered kill switch is exactly the bug this registry exists
    to make impossible.
    """
    v = _resolve(var)
    return os.environ.get(v.name, v.default)


def enabled(var) -> bool:
    """Flag-style read: True unless the variable is set to ``"0"``.

    The shared convention of the ``SKETCHES_TPU_NATIVE`` /
    ``SKETCHES_TPU_OVERLAP`` kill switches: any value other than the
    literal string ``0`` (including unset) leaves the feature on.
    """
    return get(var) != "0"
